#!/usr/bin/env python3
"""Registers and spills of the port's flash attention kernels, on a
machine with ``nvcc``.

    python3 tools/flash_probe.py

Run from the repository root.  Compiles
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` with the
port's flags and ``-Xptxas -v`` and prints one JSON line a kernel
instantiation: its name with the template widths (``fa_fwd_tc<192,128>``:
the bf16 forward at q/k width 192 and v width 128), registers a thread,
bytes of stack frame, spill stores and spill loads, and static shared
memory; then one line with ptxas's exit code and every line it wrote.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _backend  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '_Z\d+([a-z_]+)I([^']*)'")
ARGS = re.compile(r"Li(\d+)E")
USED = re.compile(r"Used (\d+) registers")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_lines() -> tuple:
    flags = [f for f in _backend.NVCC_FLAGS if f != "-shared"]
    proc = subprocess.run(
        [_backend.nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", "/dev/null",
         str(fkernel.SOURCE)], capture_output=True, text=True)
    return proc.returncode, [ln for ln in proc.stderr.splitlines()
                             if ln.strip()]


def per_kernel(lines) -> list:
    """One record an entry function, from ptxas's lines in order."""
    out, cur = [], None
    for ln in lines:
        m = ENTRY.search(ln)
        if m:
            targs = m.group(2).split("EE")[0] + "E"
            kind = ["bf16"] if "bfloat16" in targs else \
                ["f32"] if targs.startswith("f") else []
            cur = {"kernel": f"{m.group(1)}<"
                             f"{','.join(kind + ARGS.findall(targs))}>"}
            out.append(cur)
            continue
        if cur is None:
            continue
        for rx, keys in ((USED, ("registers",)),
                         (FRAME, ("stack", "spill_stores", "spill_loads")),
                         (SMEM, ("static_smem",))):
            m = rx.search(ln)
            if m:
                cur.update(zip(keys, map(int, m.groups())))
    return out


def main():
    rc, lines = ptxas_lines()
    for rec in per_kernel(lines):
        print(json.dumps(rec), flush=True)
    print(json.dumps({"phase": "ptxas", "rc": rc, "lines": lines}),
          flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
