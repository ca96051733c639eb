"""Compare the SASS of the stream+collide kernel's instantiations without
payload segments between two versions of the port's CUDA source.

    git show <rev>:src/repro_torch/kernels/lbm_collide/csrc/lbm_collide.cu > old.cu
    python tools/stencil_sass_diff.py old.cu src/repro_torch/kernels/lbm_collide/csrc/lbm_collide.cu

Needs ``nvcc`` and ``cuobjdump`` (CUDA toolkit under ``CUDA_HOME``, default
``/usr/local/cuda``); no card. Each source is compiled to a cubin for
``sm_90a`` with the build's optimisation flags once for each of the build's
(dtype, Q) parts (``-DLBM_PART_DTYPE``, ``-DLBM_PART_Q``; a source older
than the parts ignores them), all at once, its SASS dumped, and every
``stream_collide_kernel`` instantiation of the old source without payload
segments matched to the new one's by (dtype, Q, TRT, SLOTS, MEMBERS,
HALO): the solo stencils, over a slot list or a member axis, and their
halo routes (the ``fused`` and serving paths' kernels). A source older
than a template parameter lacks it, which counts as false. ``--payloads``
holds the PAYLOADS instantiations (the rank paths') to the old source too.
Instruction text is compared with addresses and encodings stripped.
Prints one line per instantiation and exits 1 when any differs or is
missing.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin")
_PARTS = ((0, 19), (0, 27), (1, 19), (1, 27))  # the build's (dtype, Q) parts
# dtype, Q, TRT, SLOTS and (newer sources only) MEMBERS, HALO and PAYLOADS
# of a mangled name
_NAME = re.compile(r"stream_collide_kernelI([fd])Li(\d+)ELb([01])ELb([01])E(?:Lb([01])E)?(?:Lb([01])E)?"
                   r"(?:Lb([01])E)?")


def _tool(name: str) -> str:
    return os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", name)


def stencils(source: Path, workdir: Path, payloads: bool = False) -> dict[tuple, list[str]]:
    """(dtype, Q, TRT, SLOTS, MEMBERS, HALO[, PAYLOADS]) -> instruction
    lines of each instantiation without payload segments (with
    ``payloads``, of every one)."""
    cubins = [workdir / f"{source.stem}_{d}_{q}.cubin" for d, q in _PARTS]
    procs = [subprocess.Popen([_tool("nvcc"), *_FLAGS, f"-DLBM_PART_DTYPE={d}", f"-DLBM_PART_Q={q}", "-o", str(c),
                               str(source)]) for (d, q), c in zip(_PARTS, cubins)]
    if any([p.wait() != 0 for p in procs]):
        raise RuntimeError(f"nvcc failed on {source}")
    dump = "".join(subprocess.run([_tool("cuobjdump"), "-sass", str(c)], capture_output=True, text=True,
                                  check=True).stdout for c in cubins)
    funcs: dict[tuple, list[str]] = {}
    current = None
    for line in dump.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            m = _NAME.search(head.group(1))
            flags = None if m is None else tuple(g or "0" for g in m.groups())
            current = None if flags is None or (flags[6] == "1" and not payloads) else flags[: 7 if payloads else 6]
            if current is not None:
                funcs[current] = []
            continue
        if current is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            funcs[current].append(re.sub(r"/\*.*?\*/", "", line).strip())
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--payloads", action="store_true", help="hold the PAYLOADS instantiations too")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        old_dir, new_dir = Path(tmp, "old"), Path(tmp, "new")
        old_dir.mkdir()
        new_dir.mkdir()
        old = stencils(args.old, old_dir, args.payloads)
        new = stencils(args.new, new_dir, args.payloads)
    same = 0
    names = ("dtype", "Q", "trt", "slots", "members", "halo", "payloads")
    by_kind: dict[str, list[int]] = {}
    for key, sass in sorted(old.items()):
        got = new.get(key)
        same += got == sass
        kind = "stencil" if key[5] == "0" else ("payloads" if key[6:] == ("1",) else "halo")
        tally = by_kind.setdefault(kind, [0, 0])
        tally[0] += got == sass
        tally[1] += 1
        verdict = "missing" if got is None else ("identical" if got == sass else "different")
        flags = ", ".join(f"{n} {v}" for n, v in zip(names, key))
        print(f"stencil ({flags}): {len(sass)} -> {None if got is None else len(got)} instructions, {verdict}")
        if got is not None and got != sass:
            print("\n".join(list(difflib.unified_diff(sass, got, lineterm=""))[:40]))
    print(", ".join(f"{k}: {s} of {n}" for k, (s, n) in sorted(by_kind.items())) + " identical")
    print(f"{same} of {len(old)} stencil instantiations have identical SASS")
    return 0 if old and same == len(old) else 1


if __name__ == "__main__":
    sys.exit(main())
