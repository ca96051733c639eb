"""The port's examples against the JAX package's, on the CPU.

* The cavity CLI twin (``examples/lbm_cavity_amr_torch.py --device cpu
  --kernel-backend ref``) and ``examples/lbm_cavity_amr.py`` in
  ``device_sharded`` at 4 ranks over 6 coarse steps print the same block
  counts, ``vmax`` within the f32 tolerance, the same ppermute and pad
  bytes, and the same held bytes a device, one integer each.
* ``DeviceShardedEngine.device_held_bytes_per_rank()`` returns one ``int``,
  the JAX package's value, at the 1, 2 and 4 ranks the JAX package's own
  tests run ``device_sharded`` at.
* The quickstart twin prints what its original prints; the resilience and
  particles twins run to their own checks.
* The MoE placement twin prints what its original prints, bitwise. The
  training twin prints its original's lines over ``TRAIN_ARGS``; its
  weights are another draw (a torch generator, not JAX's key), so each
  printed loss is held to the original's within ``TRAIN_LOSS_ABS``.

Every example runs in a subprocess, all started together when the
module's first test asks for them; the JAX runs' environment alone carries
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (one XLA device a
rank).
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
    kernel_backend="ref",
)
RANKS = (1, 2, 4)  # the JAX package's device_sharded rank counts
CLI_ARGS = ["--mode", "device_sharded", "--nranks", "4", "--steps", "6"]
# one short trajectory: 2 coarse steps, an AMR event, the held bytes
HELD = f"""
import json
from repro.lbm import AMRLBM, LidDrivenCavityConfig
out = {{}}
for n in {RANKS}:
    sim = AMRLBM(LidDrivenCavityConfig(nranks=n, stepping_mode="device_sharded", **{BASE!r}))
    sim.advance(2)
    assert sim.adapt().executed
    held = sim.engine.device_held_bytes_per_rank()
    out[n] = [type(held).__name__, held, sim.forest.num_blocks()]
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, so that parallel test workers share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", **extra)


PORT_CLI = ["--device", "cpu", "--kernel-backend", "ref", *CLI_ARGS]
TRAIN_ARGS = ["--steps", "41"]  # prints steps 0, 20 and 40
# 4x the largest difference measured between the two draws' printed losses
# (0.088 at step 40, where the losses are about 3.0 after falling from 5.6)
TRAIN_LOSS_ABS = 0.35
# every example run of the module: (env, argv), keyed by name
RUNS = {
    "jax_cli": ("xla", [str(EXAMPLES / "lbm_cavity_amr.py"), *CLI_ARGS]),
    "jax_held": ("xla", ["-c", HELD]),
    "cli": ("port", [str(EXAMPLES / "lbm_cavity_amr_torch.py"), *PORT_CLI]),
    "quickstart": ("port", [str(EXAMPLES / "quickstart.py")]),
    "quickstart_torch": ("port", [str(EXAMPLES / "quickstart_torch.py")]),
    "resilience_torch": ("port", [str(EXAMPLES / "resilience_demo_torch.py")]),
    "particles_torch": ("port", [str(EXAMPLES / "particles_in_cavity_torch.py"), "--device", "cpu", "--steps", "4",
                                 "--mode", "fused_sharded"]),
    "moe_balance": ("port", [str(EXAMPLES / "moe_diffusion_balance.py")]),
    "moe_balance_torch": ("port", [str(EXAMPLES / "moe_diffusion_balance_torch.py")]),
    "train_lm": ("port", [str(EXAMPLES / "train_lm.py"), *TRAIN_ARGS]),
    "train_lm_torch": ("port", [str(EXAMPLES / "train_lm_torch.py"), "--device", "cpu", *TRAIN_ARGS]),
}


@pytest.fixture(scope="module")
def runs() -> dict:
    """The stdout of every run in :data:`RUNS`, all started together."""
    envs = {"xla": _env(XLA_FLAGS="--xla_force_host_platform_device_count=4"), "port": _env()}
    procs = {
        key: subprocess.Popen([sys.executable, *argv], env=envs[env], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
        for key, (env, argv) in RUNS.items()
    }
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{key}: {stdout}{stderr}"
        out[key] = stdout
    return out


def _cavity_summary(out: str) -> dict:
    steps = re.findall(r"step +(\d+): blocks= *(\d+) levels=\[[^]]*\] vmax=([\d.]+) mass=([\d.]+)", out)
    ds = re.search(r"device_sharded: (\d+) ppermute bytes in (\d+) p2p messages over (\d+) in-program exchanges; "
                   r"(\d+) ppermute rounds, (\d+) pad bytes, (\d+) held bytes/device", out)
    assert steps and ds, out
    return dict(
        blocks=[int(s[1]) for s in steps],
        vmax=[float(s[2]) for s in steps],
        mass=[s[3] for s in steps],
        traffic=tuple(int(v) for v in ds.groups()[:5]),
        held=int(ds.group(6)),
    )


def test_cavity_cli_twin_prints_the_reference_numbers_in_device_sharded(runs):
    ours, theirs = _cavity_summary(runs["cli"]), _cavity_summary(runs["jax_cli"])
    assert ours["blocks"] == theirs["blocks"] and ours["blocks"][-1] > ours["blocks"][0]
    assert ours["mass"] == theirs["mass"]
    # vmax is printed to 4 decimals: equal within one printed unit
    assert all(abs(a - b) <= 1e-4 for a, b in zip(ours["vmax"], theirs["vmax"])), (ours["vmax"], theirs["vmax"])
    # bytes, messages, exchanges, rounds and pad bytes
    assert ours["traffic"] == theirs["traffic"] and ours["traffic"][4] > 0
    assert ours["held"] == theirs["held"] > 0


def test_held_bytes_per_rank_is_the_reference_int(runs):
    theirs = {int(n): v for n, v in json.loads(runs["jax_held"].strip().splitlines()[-1]).items()}
    for n in RANKS:
        sim = AMRLBM(LidDrivenCavityConfig(nranks=n, stepping_mode="device_sharded", device="cpu", **BASE))
        sim.advance(2)
        assert sim.adapt().executed
        held = sim.engine.device_held_bytes_per_rank()
        assert type(held) is int and theirs[n][0] == "int", (held, theirs[n])
        assert [held, sim.forest.num_blocks()] == theirs[n][1:], (n, held, theirs[n])
        assert sim.engine.device_held_bytes_by_rank() == [held] * n


def test_quickstart_twin_prints_what_its_original_prints(runs):
    ours, theirs = runs["quickstart_torch"], runs["quickstart"]
    # stage timings differ run to run; everything else is the same text
    strip = re.compile(r" *\d+\.\d+ ms")
    assert strip.sub("", ours) == strip.sub("", theirs)


def test_resilience_twin_restores_and_reloads_intact(runs):
    out = runs["resilience_torch"]
    assert "restored on 5 ranks: 64 blocks" in out and "(OK)" in out
    assert "disk checkpoint reloaded onto 12 ranks" in out


def test_particles_twin_conserves_its_tracers_on_the_cpu(runs):
    out = runs["particles_torch"]
    assert "seeded 128 tracers" in out and "device=cpu" in out and "advected 512" in out
    assert re.search(r"step +4: com=\(", out) and "weighted load per rank" in out


def test_moe_balance_twin_prints_what_its_original_prints(runs):
    assert runs["moe_balance_torch"] == runs["moe_balance"]
    assert "peak overload (max/avg)" in runs["moe_balance_torch"]


def _train_lines(out: str) -> tuple[list[str], list[tuple[int, float]], float]:
    steps = [(int(i), float(loss)) for i, loss in re.findall(r"step +(\d+) loss= *([\d.]+) gnorm=", out)]
    final = re.search(r"final loss: ([\d.]+)", out)
    assert steps and final, out
    head = [line for line in out.splitlines() if line.startswith(("arch=", "data buckets"))]
    return head, steps, float(final.group(1))


def test_train_lm_twin_prints_the_originals_lines(runs):
    ours, theirs = _train_lines(runs["train_lm_torch"]), _train_lines(runs["train_lm"])
    assert len(ours[0]) == 2 and ours[0] == theirs[0]  # parameter count, bucket balance
    assert [i for i, _ in ours[1]] == [i for i, _ in theirs[1]] == [0, 20, 40]
    for (i, a), (_, b) in zip(ours[1], theirs[1]):
        assert abs(a - b) <= TRAIN_LOSS_ABS, (i, a, b)
    assert abs(ours[2] - theirs[2]) <= TRAIN_LOSS_ABS
    assert ours[1][-1][1] < ours[1][0][1] - 2.0  # it learns the structure
