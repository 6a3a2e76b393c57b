"""Subprocess program: one rank of a gloo process group running the port's
distributed training pieces on the CPU.  Run by
tests/test_torch_train_dist.py, one process per rank:

    python torch_train_dist.py RANK WORLD INIT_FILE OUT_DIR

Every rank makes the same seeded inputs (those of tests/progs/
dist_compress.py and dist_pipeline.py, at WORLD ranks): compressed_allreduce
of per-rank gradients (WORLD, 4096) with error feedback, and a
WORLD-stage GPipe pipeline of 8 tanh layers over 8 microbatches.  Writes
OUT_DIR/rank<RANK>.npz: the summed gradient, the new residual, the
pipeline's output and the number of send / receive pairs per tick.
Imports only repro_torch."""
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train import compress, pipeline

L, D, T, MB = 8, 16, 8, 4


def inputs(world):
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(world, 4096)) * 0.1).astype(np.float32)
    ws = (rng.normal(size=(L, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(T, MB, D)).astype(np.float32)
    return g, ws, x


def main():
    torch.set_num_threads(1)
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out = sys.argv[3], pathlib.Path(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        g, ws, x = inputs(world)
        err0 = torch.zeros(4096 // world)
        summed, err = compress.compressed_allreduce(
            torch.from_numpy(g[rank]), err0)

        pairs = []
        real = dist.batch_isend_irecv

        def counted(ops):
            pairs.append(len(ops))
            return real(ops)

        dist.batch_isend_irecv = counted

        def stage_fn(sp, h):           # sp: (L/S, D, D), this segment
            for w in sp:
                h = torch.tanh(h @ w)
            return h

        got = pipeline.pipeline_apply(
            stage_fn, pipeline.split_stages(torch.from_numpy(ws), world),
            torch.from_numpy(x))
        dist.batch_isend_irecv = real
        np.savez(out / f"rank{rank}.npz", summed=summed.numpy(),
                 err=err.numpy(), pipeline=got.numpy(),
                 pairs=np.array(pairs))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
