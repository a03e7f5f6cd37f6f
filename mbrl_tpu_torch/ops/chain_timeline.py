"""Where one block of K2 or K3 spends its time, phase by phase, on the card.

    python3 -m mbrl_tpu_torch.ops.chain_timeline

Builds the kernels with ``-DTC_TIMELINE`` (a library of its own in
``mbrl_tpu_torch/_build/``), runs K2 at config B's shapes (E=5 x S=1,600 rows,
in 24, 4x200 silu, head 36) in f32 and bf16, and prints, for block (0, 0), the
microseconds from its start to each mark of ``csrc/tc_chain.cuh``: barriers
set up, input tile built, then for every product the end of its wgmma, the
barrier after it and the end of its epilogue (for a hidden layer also its
stores issued and fenced, before the closing barrier), and the sampled output. Then K3
at the same shape (one tile a block) and at S=20,000 (a persistent block
walking 11 or 12 tiles): the same marks for the last tile block 0 ran, counted
from that tile's start, with the block's whole time and its tiles. Needs a
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
        if i < min(num_products - 1, 4):  # inside a hidden layer's epilogue
            names[18 + i] = f"p{i}_stored"
            names[22 + i] = f"p{i}_fenced"
    names[31] = "sampled"
    return names


def _inputs(dtype: torch.dtype, rows: int):
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    ws = [torch.randn((MEMBERS, a, b), generator=g) / a**0.5 for a, b in zip(DIMS[:-1], DIMS[1:])]
    bs = [0.1 * torch.randn((MEMBERS, 1, b), generator=g) for b in DIMS[1:]]
    stack = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                       ws[-1].to(dev), bs[-1].to(dev), "silu", dtype=dtype)
    x = torch.randn((MEMBERS, rows, DIMS[0]), generator=g).to(dev)
    return g, x, stack, K.pack_chain(stack)


def _read(reader) -> list:
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 64)()
    if reader(buf) != 0:
        raise RuntimeError("could not read the timeline")
    return list(buf)


def timeline(dtype: torch.dtype, lib) -> dict:
    from mbrl_tpu_torch.ops import kernels as K

    g, x, stack, tiles = _inputs(dtype, ROWS)
    max_lv = torch.full((1, OUT), 0.5, device=x.device)
    min_lv = torch.full((1, OUT), -10.0, device=x.device)
    for _ in range(3):  # the last launch's marks are read
        K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OUT, tiles=tiles)
    buf = _read(lib.mbrl_timeline)
    return {name: round((buf[k] - buf[0]) / 1e3, 3) for k, name in marks(len(DIMS) - 1).items()}


def timeline_k3(dtype: torch.dtype, rows: int, lib) -> dict:
    """Block 0's last tile, from that tile's start (mark 29), and the block's
    whole time over its tiles."""
    from mbrl_tpu_torch.ops import kernels as K

    _, x, stack, tiles = _inputs(dtype, rows)
    for _ in range(3):
        K.fused_ensemble_mlp(x, stack, tiles=tiles)
    buf = _read(lib.mbrl_timeline_k3)
    names = {k: n for k, n in marks(len(DIMS) - 1).items() if 2 <= k < 29}
    names[30] = "head_written"
    blocks = K.persistent_blocks(rows, MEMBERS, K.sm_count(x.device))
    return {
        "rows_per_member": rows, "blocks": blocks,
        "tiles_of_block_0": len(K.block_tiles(0, rows, MEMBERS, blocks)),
        "block_us": round((buf[30] - buf[0]) / 1e3, 3),
        "last_tile_us_since_its_start": {n: round((buf[k] - buf[29]) / 1e3, 3)
                                         for k, n in sorted(names.items())},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    from mbrl_tpu_torch.ops import build

    build.EXTRA_FLAGS = ("-DTC_TIMELINE",)
    lib = build.load_library()
    lib.mbrl_timeline.argtypes = [ctypes.c_void_p]
    lib.mbrl_timeline_k3.argtypes = [ctypes.c_void_p]
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K2", "dtype": name, "us_since_start": timeline(dtype, lib)}),
              flush=True)
    for rows in (ROWS, 20_000):
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3", "dtype": name, **timeline_k3(dtype, rows, lib)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
