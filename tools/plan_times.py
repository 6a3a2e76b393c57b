"""Host-clock times of the f32 SO(3) plans of one source tree, on one CUDA card.

    python3 tools/plan_times.py [DIR ...]

For each DIR (default: this tree; for example a `git archive` of an
earlier commit unpacked beside it, to compare parent and change in one
call as parent, change, change, parent), imports repro_torch from
DIR/src in a fresh process and times inverse_batch(8) and forward_batch(8)
of plan(64, float32) with impl fused / onthefly / dense / ragged and
lchunk 16, and of plan(128, float32, precision="bf16"): the mean of 20
synchronized calls after a warmup, on random coefficients from a seed.
Prints one JSON line per DIR.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

PLANS = (("b64_fused", 64, {}), ("b64_onthefly", 64, {"impl": "onthefly"}),
         ("b64_dense", 64, {"impl": "dense"}), ("b64_ragged", 64, {"impl": "ragged"}),
         ("b64_lchunk16", 64, {"lchunk": 16}), ("b128_bf16", 128, {"precision": "bf16"}))


def host_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def times(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch
    from repro_torch.core import soft

    out = {"tree": str(tree)}
    for label, B, kw in PLANS:
        t = repro_torch.plan(B, torch.float32, **kw)
        gen = torch.Generator(device="cuda").manual_seed(0)
        shape = (8, B, 2 * B - 1, 2 * B - 1)
        fh = torch.complex(torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
                           torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
        fh.mul_(torch.as_tensor(soft.coeff_mask(B), device="cuda"))
        fs = t.inverse_batch(fh)
        out[label] = {"inverse_batch_ms": host_ms(lambda: t.inverse_batch(fh)),
                      "forward_batch_ms": host_ms(lambda: t.forward_batch(fs))}
        del t, fh, fs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(times(pathlib.Path(sys.argv[2]).resolve())), flush=True)
        return 0
    trees = sys.argv[1:] or [str(pathlib.Path(__file__).resolve().parent.parent)]
    rc = 0
    for tree in trees:    # one process each: the two trees' modules share names
        rc |= subprocess.run([sys.executable, __file__, "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
