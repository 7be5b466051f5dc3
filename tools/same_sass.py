#!/usr/bin/env python3
"""Compare the machine code of two CUDA kernels, each from its own source.

    python3 tools/same_sass.py OLD.cu KERNEL_OLD NEW.cu KERNEL_NEW

Each source is compiled to a cubin with the flags of
gsplatloc_tpu_torch/kernels/__init__.py (its own directory on the include
path), `cuobjdump -sass` lists the code of the kernel whose mangled name
contains KERNEL_*, and the two listings are compared instruction by
instruction (the function's name and the code addresses aside). Prints
the instruction counts and whether the code is identical; exits 1 if it
is not. Needs the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gsplatloc_tpu_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402


def kernel_sass(src: Path, kernel: str, cubin: Path) -> list[str]:
    """The instructions of `kernel` in src's cubin, without addresses."""
    nvcc = _nvcc()
    subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(src.parent), "-cubin",
                    str(src), "-o", str(cubin)], check=True)
    dump = subprocess.run(
        [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        stdout=subprocess.PIPE, text=True, check=True).stdout
    code, inside = [], False
    for line in dump.splitlines():
        if line.strip().startswith("Function :"):
            inside = kernel in line
            continue
        if inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                code.append(m.group(1))
    if not code:
        raise SystemExit(f"no kernel matching {kernel!r} in {src}")
    return code


def main():
    if len(sys.argv) != 5:
        raise SystemExit(__doc__)
    old_src, old_k, new_src, new_k = sys.argv[1:]
    with tempfile.TemporaryDirectory() as d:
        old = kernel_sass(Path(old_src).resolve(), old_k,
                          Path(d) / "old.cubin")
        new = kernel_sass(Path(new_src).resolve(), new_k,
                          Path(d) / "new.cubin")
    same = old == new
    print(f"{old_k}: {len(old)} instructions; {new_k}: {len(new)} "
          f"instructions; identical machine code: {same}")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
