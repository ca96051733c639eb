"""Launcher: production mesh, multi-pod dry-run, HLO roofline analysis,
training/serving drivers."""
