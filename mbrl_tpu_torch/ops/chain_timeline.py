"""Where one block of K2 spends its time, phase by phase, on the card.

    python3 -m mbrl_tpu_torch.ops.chain_timeline

Builds the kernels with ``-DTC_TIMELINE`` (a library of its own in
``mbrl_tpu_torch/_build/``), runs K2 at config B's shapes (E=5 x S=1,600 rows,
in 24, 4x200 silu, head 36) in f32 and bf16, and prints, for block (0, 0), the
microseconds from its start to each mark of ``csrc/tc_chain.cu``: barriers set
up, input tile built, then for every product the end of its wgmma, the
barrier after it and the end of its epilogue, and the sampled output. Needs a
CUDA device; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

SEED = 0
DIMS = (24, 200, 200, 200, 200, 36)
MEMBERS, ROWS, OUT = 5, 1600, 18


def marks(num_products: int):
    names = {0: "start", 1: "barriers", 2: "input"}
    for i in range(num_products):
        names[3 + 3 * i] = f"p{i}_products"
        names[4 + 3 * i] = f"p{i}_synced"
        names[5 + 3 * i] = f"p{i}_epilogue"
    names[31] = "sampled"
    return names


def timeline(dtype: torch.dtype, lib) -> dict:
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    ws = [torch.randn((MEMBERS, a, b), generator=g) / a**0.5 for a, b in zip(DIMS[:-1], DIMS[1:])]
    bs = [0.1 * torch.randn((MEMBERS, 1, b), generator=g) for b in DIMS[1:]]
    stack = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                       ws[-1].to(dev), bs[-1].to(dev), "silu", dtype=dtype)
    tiles = K.pack_chain(stack)
    x = torch.randn((MEMBERS, ROWS, DIMS[0]), generator=g).to(dev)
    max_lv = torch.full((1, OUT), 0.5, device=dev)
    min_lv = torch.full((1, OUT), -10.0, device=dev)
    for _ in range(3):  # the last launch's marks are read
        K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OUT, tiles=tiles)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if lib.mbrl_timeline(buf) != 0:
        raise RuntimeError("could not read the timeline")
    t0 = buf[0]
    return {name: round((buf[k] - t0) / 1e3, 3) for k, name in marks(len(DIMS) - 1).items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    from mbrl_tpu_torch.ops import build

    build.EXTRA_FLAGS = ("-DTC_TIMELINE",)
    lib = build.load_library()
    lib.mbrl_timeline.argtypes = [ctypes.c_void_p]
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        print(json.dumps({"kernel": "K2", "dtype": name, "us_since_start": timeline(dtype, lib)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
