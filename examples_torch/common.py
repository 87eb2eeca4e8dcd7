"""Shared helpers of the PyTorch examples: the synthetic data generators and
the device choice.

Counterpart of ``examples/common.py``.  Every generator draws from a seeded
``np.random.RandomState`` and returns the same arrays as the JAX package's
for the same seed, bit for bit: ``data_loader``, ``random_scene``,
``random_point_cloud``, and the synthetic ModelNet shapes (``synthetic_shape``,
``CoordinateTransformation``, ``modelnet_batch``), which the package keeps in
``minkowskiengine_tpu_torch/utils/datasets.py``.  ``data_loader`` collates
with the package's ``sparse_collate``, so its coordinates and features come
back as tensors.

The scripts run this file by its path (``runpy.run_path``), so another
module called ``common`` cannot stand in for it; it puts the repository
root, which holds the package, on ``sys.path`` for them.

The multi-process scripts run one process per rank through ``run_world``
(``world_parser`` adds its flags).  A spawned process finds its target by
the script's path: a module loaded by its path cannot be pickled as a
spawn target, so the spawn target is this file's ``_rank_entry``, imported
as ``examples_torch.common``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import importlib.util
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = str(Path(__file__).resolve().parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.utils.datasets import (  # noqa: F401,E402  (re-exported)
    SHAPE_CLASSES,
    CoordinateTransformation,
    make_room_scan,
    modelnet_batch,
    synthetic_shape,
)


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--cpu`` flag."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    return p


def device_of(args) -> torch.device:
    """The card unless ``--cpu`` was given; without a card and without
    ``--cpu`` this raises, as the package's entry points do: nothing runs
    on the CPU unasked."""
    return torch.device("cpu") if args.cpu else MT.types.resolve_device(None)


def world_parser(description: str) -> argparse.ArgumentParser:
    """``parser`` with the multi-process flags: ``--world`` and ``--backend``."""
    p = parser(description)
    p.add_argument("--world", type=int, default=None,
                   help="ranks, one process each (default: the cards, or 2 under --cpu)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend (default: nccl on the card, gloo on the CPU)")
    return p


def _load_script(script, name: str):
    """A script by its path, under a module name of its own."""
    spec = importlib.util.spec_from_file_location(name, str(script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def _joined(backend: str, rank: int, world: int, init_method: str):
    """This process as ``rank`` of a ``torch.distributed`` world, for the
    block's length."""
    device_id = None
    if backend == "nccl":  # one card per rank
        device_id = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                                 % torch.cuda.device_count())
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            device_id=device_id)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run(script, target: str, rank: int, world: int, args):
    return getattr(_load_script(script, f"{Path(script).stem}_rank{rank}"), target)(
        rank, world, args)


def _rank_entry(rank, script, target, args, world, backend, store, threads):
    """One spawned rank: join the world, run ``target`` of the script at
    ``script``, and leave its result in the store's directory."""
    torch.set_num_threads(threads)
    with _joined(backend, rank, world, f"file://{store}/store"):
        torch.save(_run(script, target, rank, world, args), f"{store}/rank{rank}.pt")


def run_world(script, target: str, args) -> list:
    """Run ``target(rank, world, args)`` of the script at path ``script`` on
    every rank of a ``torch.distributed`` world and return the ranks'
    results, in rank order.

    - Launched by ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set): this
      process joins that world (``env://``) and gathers every rank's
      result (``all_gather_object``).
    - Else ``args.world`` ranks (default: the cards, or 2 under ``--cpu``)
      over a ``file://`` store in a temporary directory: rank 0 runs in this
      process when the world is 1; otherwise ``torch.multiprocessing``
      spawns one process per rank, each on its share of this process's
      torch threads (ranks that spin on more threads than the cores hold
      run many times slower), and a rank's result comes back through a
      file.

    The backend is ``args.backend``, by default NCCL on the card and gloo
    under ``--cpu``.  NCCL takes one card per rank; ranks sharing a card
    need gloo.  Without a card and without ``--cpu`` this raises."""
    if not args.cpu:
        MT.types.resolve_device(None)  # raises without a card
    backend = args.backend or ("gloo" if args.cpu else "nccl")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        with _joined(backend, rank, world, "env://"):
            ranks = [None] * world
            dist.all_gather_object(ranks, _run(script, target, rank, world, args))
            return ranks
    world = args.world or (2 if args.cpu else torch.cuda.device_count())
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards; pass --backend gloo")
    store = tempfile.mkdtemp(prefix="me_world_")
    try:
        if world == 1:
            with _joined(backend, 0, 1, f"file://{store}/store"):
                return [_run(script, target, 0, 1, args)]
        # a spawn target must be importable by name in the new process
        entry = importlib.import_module("examples_torch.common")._rank_entry
        mp.start_processes(entry, args=(str(script), target, args, world, backend, store,
                                        max(1, torch.get_num_threads() // world)),
                           nprocs=world, start_method="spawn")
        return [torch.load(f"{store}/rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(store, ignore_errors=True)


def rank_device(args) -> torch.device:
    """This rank's device: the CPU under ``--cpu``, else its card
    (``parallel.data_parallel.rank_device``)."""
    from minkowskiengine_tpu_torch.parallel.data_parallel import rank_device as on

    return on("cpu" if args.cpu else "cuda")


def kernel_launches() -> dict:
    """The launches of the CUDA kernels so far in this process (0 on the
    CPU, which runs their plain versions)."""
    from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw
    from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm

    return {"gather_gemm": gather_gemm.launches, "conv_dw": conv_dw.launches}


def since(before: dict, now: dict) -> dict:
    return {k: now[k] - before[k] for k in before}


def digest(model) -> str:
    """A hash of every parameter's bytes: two ranks' agree only when their
    parameters are bit-equal."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def random_cloud(seed, n, hi):
    """(coordinates (M, 4) int32, features (M, 3) float32, the generator
    after them): ``n`` random voxels in ``hi``³ over two batch indices,
    duplicates merged, as the JAX package's multi-device examples draw
    their clouds (``examples/multigpu.py:52-60``,
    ``examples/multigpu_ddp.py:27-35``, ``examples/tensor_parallel.py:62-69``)."""
    rng = np.random.RandomState(seed)
    coords = np.unique(
        np.concatenate([rng.randint(0, 2, (n, 1)), rng.randint(0, hi, (n, 3))], axis=1)
        .astype(np.int32),
        axis=0,
    )
    return coords, rng.randn(len(coords), 3).astype(np.float32), rng


def data_loader(nchannel=3, max_label=5, is_classification=True, seed=0,
                batch_size=4, dimension=2):
    """Tiny deterministic batch, reference-style
    (tests/python/common.py:57-70): (coordinates (N, D+1) int32 tensor,
    features (N, nchannel) float32 tensor, labels int32 array: one per
    cloud, or one per row)."""
    rng = np.random.RandomState(seed)
    coords_list, feats_list, labels = [], [], []
    for _ in range(batch_size):
        n = rng.randint(20, 40)
        coords = rng.randint(-10, 10, (n, dimension))
        feats = rng.randn(n, nchannel).astype(np.float32)
        coords_list.append(coords)
        feats_list.append(feats)
        labels.append(rng.randint(0, max_label))
    coords, feats = MT.utils.sparse_collate(coords_list, feats_list)
    if is_classification:
        label = np.array(labels, np.int32)
    else:
        label = rng.randint(0, max_label, len(coords)).astype(np.int32)
    return coords, feats, label


def random_scene(n_points=10000, room=(100, 100, 50), batch_size=1, seed=0):
    """ScanNet-like voxelized room(s): unique int voxels + rgb-ish features."""
    rng = np.random.RandomState(seed)
    coords = np.unique(
        np.concatenate(
            [
                rng.randint(0, batch_size, (n_points * 2, 1)),
                rng.randint(0, room[0], (n_points * 2, 1)),
                rng.randint(0, room[1], (n_points * 2, 1)),
                rng.randint(0, room[2], (n_points * 2, 1)),
            ],
            axis=1,
        ).astype(np.int32),
        axis=0,
    )[:n_points]
    feats = rng.rand(len(coords), 3).astype(np.float32)
    labels = rng.randint(0, 20, len(coords)).astype(np.int32)
    return coords, feats, labels


def random_point_cloud(n_points=2048, batch_size=4, scale=20.0, seed=0):
    """Continuous-coordinate point clouds for TensorField pipelines."""
    rng = np.random.RandomState(seed)
    coords = np.concatenate(
        [
            rng.randint(0, batch_size, (n_points, 1)).astype(np.float32),
            (rng.rand(n_points, 3) * scale).astype(np.float32),
        ],
        axis=1,
    )
    feats = rng.randn(n_points, 3).astype(np.float32)
    labels = rng.randint(0, 40, batch_size).astype(np.int32)
    return coords, feats, labels
