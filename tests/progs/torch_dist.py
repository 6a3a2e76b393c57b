"""Subprocess program: one rank of a gloo process group running the
port's mesh plans on the CPU.  Run by tests/test_torch_dist.py, one
process per rank:

    python torch_dist.py RANK WORLD INIT_FILE IN_NPZ OUT_DIR

Reads the coefficient sets, the reference's samples and the B list from
IN_NPZ; writes OUT_DIR/rank<RANK>.npz (every executor's output) and
OUT_DIR/rank<RANK>.json (stats, all-to-all counts, the measured overlap
winner, the resolved schedules and the correlation checks).  Imports
only repro_torch."""
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)

from repro_torch import plan  # noqa: E402
from repro_torch.core import parallel, soft  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.so3 import s2  # noqa: E402
from repro_torch.so3.correlate import (CorrelationEngine,  # noqa: E402
                                      angle_error, random_rotation,
                                      result_key)

IMPLS = ("fused", "dense", "reference")


def planted_pair(B, seed):
    rng = np.random.default_rng(seed)
    true = random_rotation(rng)
    g = soft.random_s2_coeffs(B, seed=seed)
    return s2.rotate_s2_coeffs(g, true), g, true


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, in_npz, out_dir = sys.argv[3], sys.argv[4], \
        pathlib.Path(sys.argv[5])
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    data = np.load(in_npz)
    out, info = {}, {"stats": {}, "all_to_alls": {}, "schedule": {}}
    for B in [int(b) for b in data["Bs"]]:
        fhats, f_ref = data[f"fhats{B}"], data[f"f_ref{B}"]
        for impl in IMPLS:
            t = plan(B, device="cpu", mesh=mesh, axis=("data",), impl=impl,
                     V=2)
            tag = f"B{B}_{impl}"
            out[f"{tag}_inverse"] = t.inverse(fhats[0]).numpy()
            out[f"{tag}_forward"] = t.forward(f_ref[0]).numpy()
            for mode in parallel.OVERLAP_MODES:
                parallel.reset_all_to_alls()
                t.reset_stats()
                out[f"{tag}_inverse_batch_{mode}"] = \
                    t.inverse_batch(fhats, overlap=mode).numpy()
                out[f"{tag}_forward_batch_{mode}"] = \
                    t.forward_batch(f_ref, overlap=mode).numpy()
                info["stats"][f"{tag}_{mode}"] = dict(t.stats)
                info["all_to_alls"][f"{tag}_{mode}"] = \
                    dict(parallel.ALL_TO_ALLS)
            info["schedule"][tag] = [t.schedule.tk, t.schedule.V,
                                     t.schedule.overlap, t.n_shards]
    B = int(data["Bs"][0])
    tm = plan(B, device="cpu", mesh=mesh, axis=("data",),
              tune="measure", tune_reps=1,
              tune_cache=str(out_dir / f"tune{rank}.json"))
    info["measured"] = [tm.schedule.source, tm.schedule.impl,
                        tm.schedule.tk, tm.schedule.V, tm.schedule.overlap]
    out["measured_inverse"] = tm.inverse(data[f"fhats{B}"][0]).numpy()
    info["overlap"] = autotune.autotune_overlap(
        tm.soft_plan, mesh, ("data",), V=2, n_chunks=2, reps=1,
        cache=str(out_dir / "overlap.json"))
    eng = plan(B, device="cpu", mesh=mesh, axis=("data",), V=2).engine()
    local = CorrelationEngine(B, lane_width=1, device="cpu")
    pairs = [planted_pair(B, 100 + s) for s in range(3)]
    got = eng.match_batch([p[0] for p in pairs], [p[1] for p in pairs])
    info["correlation_keys_equal"] = [
        result_key(r) == result_key(local.match(f, g))
        for r, (f, g, _) in zip(got, pairs)]
    info["correlation_errors"] = [
        max(angle_error(a, b) for a, b in zip(
            (r.alpha, r.beta, r.gamma), true)) * B / np.pi
        for r, (_, _, true) in zip(got, pairs)]
    np.savez(out_dir / f"rank{rank}.npz", **out)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
