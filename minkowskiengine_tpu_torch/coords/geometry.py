"""Geometry: a coordinate manager's cached state as a step's argument.

Counterpart of ``minkowskiengine_tpu/coords/geometry.py``.  Training on
fresh geometry means a new point cloud every batch, so every batch needs
its own coordinate phase (unique, strided maps, kernel maps).  The eager
manager builds it inside the forward, one op and several host syncs at a
time.  Here the coordinate ops are recorded once, then replayed per batch
without the model, and the result is handed to the step as a
``Geometry``::

    x = MT.SparseTensor(feats, coords)          # builds maps, records the oplog
    _ = net(x)                                  # the first (eager) forward
    replayer = MT.GeometryReplayer(x.coordinate_manager)
    for coords, feats in warm_batches:          # ratchet the capacity floors
        replayer(coords)
    compiled = MT.CompiledReplayer(x.coordinate_manager).adopt(replayer)

    # per fresh batch:
    geo, fp = compiled(coords, feats)           # one CUDA graph, one host sync
    mgr = MT.CoordinateManager.from_geometry(geo)   # frozen view
    xt = MT.SparseTensor(fp, coordinate_map_key=geo.entry_key,
                         coordinate_manager=mgr)
    loss = criterion(net(xt).F, labels)         # every map a cache hit

A Geometry's maps hold exact row counts, like every map the model sees;
the padded capacities live only inside the replay.  It is a plain
dataclass, not a pytree: the step takes it as an argument as it is.  Its
dense plans (``ops/dense_conv.py``) serve the dense-grid conv route in a
step on a frozen view, and the replayers ratchet each map's grid shape
(``grid_floors``) as they ratchet its capacity.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional, Tuple

import torch

from ..ops.dense_conv import DensePlan
from .kernel_map import KernelMap
from .keys import PAD_KEY
from .manager import CoordinateManager, CoordinateMapKey, UntraceableReplay
from .map import CoordinateMap, bucket_capacity


@dataclasses.dataclass
class Geometry:
    """Snapshot of a manager's coordinate maps, kernel maps, stride maps
    and dense plans (None for an empty map).

    ``origin_keys`` maps a key tuple to its origin map's key tuple.
    ``row_shapes`` is set on a stacked Geometry only (``stack_geometries``):
    each tensor's shape in each stacked geometry, by its place in the dicts,
    and each dense plan's grid shape.
    """

    D: int
    maps: Dict[tuple, CoordinateMap]
    kernel_maps: Dict[tuple, KernelMap]
    stride_maps: Dict[tuple, torch.Tensor]
    dense_plans: Dict[tuple, Optional[DensePlan]]
    origin_keys: Dict[tuple, tuple]
    entry_key_tuple: Optional[Tuple[Tuple[int, ...], str]] = None
    row_shapes: Optional[Dict[tuple, List[tuple]]] = None

    @property
    def entry_key(self) -> CoordinateMapKey:
        """The key of the first inserted map (the network input)."""
        if self.entry_key_tuple is None:
            raise ValueError("Geometry has no recorded entry map")
        return CoordinateMapKey(*self.entry_key_tuple)

    @property
    def device(self) -> torch.device:
        return next(iter(self.maps.values())).coordinates.device

    def to(self, device) -> "Geometry":
        """The same geometry with every tensor on ``device``."""
        return _with_tensors(self, {p: t.to(device) for p, t, _ in _tensors(self)}, self.row_shapes)


def _tensors(geo: Geometry):
    """(place, tensor, fill value of padding) of every tensor of ``geo``."""
    out = []
    for k, m in geo.maps.items():
        out += [(("maps", k, 0), m.coordinates, 0), (("maps", k, 1), m.keys, PAD_KEY)]
    for k, km in geo.kernel_maps.items():
        out += [(("kernel_maps", k, 0), km.in_idx, -1), (("kernel_maps", k, 1), km.out_idx_t, -1)]
    for k, sm in geo.stride_maps.items():
        out.append((("stride_maps", k, 0), sm, -1))
    for k, p in geo.dense_plans.items():
        if p is not None:
            out += [(("dense_plans", k, 0), p.flat_idx, -1), (("dense_plans", k, 1), p.mins, 0)]
    return out


def _grid_place(k):
    """The place under which a stacked Geometry keeps a plan's grid shapes."""
    return ("dense_plans", k, "grid_shape")


def _with_tensors(geo: Geometry, t: dict, row_shapes=None, grid_shapes=None) -> Geometry:
    """``geo`` with its tensors replaced by ``t`` (by place), and its plans'
    grid shapes by ``grid_shapes`` where given."""
    grid_shapes = grid_shapes or {}
    return Geometry(
        D=geo.D,
        maps={k: CoordinateMap(t[("maps", k, 0)], t[("maps", k, 1)], m.tensor_stride)
              for k, m in geo.maps.items()},
        kernel_maps={
            k: KernelMap(t[("kernel_maps", k, 0)], t[("kernel_maps", k, 1)],
                         t[("kernel_maps", k, 1)].shape[-1], t[("kernel_maps", k, 0)].shape[-1])
            for k in geo.kernel_maps
        },
        stride_maps={k: t[("stride_maps", k, 0)] for k in geo.stride_maps},
        dense_plans={
            k: None if p is None else DensePlan(
                t[("dense_plans", k, 0)], grid_shapes.get(k, p.grid_shape), t[("dense_plans", k, 1)])
            for k, p in geo.dense_plans.items()
        },
        origin_keys=dict(geo.origin_keys),
        entry_key_tuple=geo.entry_key_tuple,
        row_shapes=row_shapes,
    )


def _structure(geo: Geometry):
    return (
        geo.D, sorted(map(repr, geo.maps)), sorted(map(repr, geo.kernel_maps)),
        sorted(map(repr, geo.stride_maps)), sorted(map(repr, geo.origin_keys.items())),
        sorted(repr((k, p is None)) for k, p in geo.dense_plans.items()), geo.entry_key_tuple,
    )


def stack_geometries(geometries: List[Geometry]) -> Geometry:
    """Stack geometries with the same keys along a new leading axis.

    The maps' row counts differ from cloud to cloud, so each tensor is
    padded to the largest shape among them (``PAD_KEY`` in keys, -1 in
    index maps, 0 in coordinates) and ``row_shapes`` keeps each one's
    shape; ``index_geometry`` cuts them back.  Geometries with different
    keys raise ``ValueError``.  Dense plans may differ in grid shape:
    ``row_shapes`` keeps each one's.
    """
    first = geometries[0]
    if any(_structure(g) != _structure(first) for g in geometries[1:]):
        raise ValueError("stack_geometries needs geometries with the same keys")
    per_geo = [{p: t for p, t, _ in _tensors(g)} for g in geometries]
    stacked, row_shapes = {}, {}
    for place, t0, fill in _tensors(first):
        parts = [g[place] for g in per_geo]
        shape = [max(p.shape[d] for p in parts) for d in range(t0.ndim)]
        out = t0.new_full([len(parts)] + shape, fill)
        for i, p in enumerate(parts):
            out[(i,) + tuple(slice(0, s) for s in p.shape)] = p
        stacked[place], row_shapes[place] = out, [tuple(p.shape) for p in parts]
    for k, p in first.dense_plans.items():
        if p is not None:
            row_shapes[_grid_place(k)] = [g.dense_plans[k].grid_shape for g in geometries]
    return _with_tensors(first, stacked, row_shapes)


def index_geometry(geo: Geometry, i: int) -> Geometry:
    """Geometry ``i`` of a stacked one, each tensor cut to its own shape."""
    if geo.row_shapes is None:
        raise ValueError("index_geometry takes a stacked Geometry (stack_geometries)")
    grids = {k: geo.row_shapes[_grid_place(k)][i] for k, p in geo.dense_plans.items() if p is not None}
    return _with_tensors(geo, {
        p: t[(i,) + tuple(slice(0, s) for s in geo.row_shapes[p][i])].contiguous()
        for p, t, _ in _tensors(geo)
    }, grid_shapes=grids)


def slice_geometry(geo: Geometry, lo: int, hi: int) -> Geometry:
    """Geometries ``lo``..``hi - 1`` of a stacked one, still stacked (a
    rank's share of a stack, ``parallel.shard_batch``)."""
    if geo.row_shapes is None:
        raise ValueError("slice_geometry takes a stacked Geometry (stack_geometries)")
    return _with_tensors(
        geo, {p: t[lo:hi] for p, t, _ in _tensors(geo)},
        {p: s[lo:hi] for p, s in geo.row_shapes.items()},
    )


def squeeze_geometry(geo: Geometry) -> Geometry:
    """The one geometry of a stack of one."""
    if geo.row_shapes is None or len(next(iter(geo.row_shapes.values()))) != 1:
        raise ValueError("squeeze_geometry takes a stack of one Geometry")
    return index_geometry(geo, 0)


class GeometryReplayer:
    """Per-batch coordinate phase that carries the capacity floors forward.

    Each call replays the recipe on a new cloud (deferred: one host
    transfer, or the sync replay where a floor is missing or too small) and
    ratchets the floors, so that after a couple of batches every map fits
    its floor::

        replayer = MT.GeometryReplayer(x.coordinate_manager)
        for coords, feats in batches:
            mgr = replayer(coords)
            geo = mgr.export_geometry()
            fp = mgr.reduce_features(geo.entry_key, feats)
    """

    def __init__(self, recorded_manager: CoordinateManager):
        self.oplog = recorded_manager.oplog()
        self.cap_floors = dict(recorded_manager._cap_floors)
        self.grid_floors = dict(recorded_manager._grid_floors)
        self.device = recorded_manager.device

    def __call__(self, coordinates, tensor_stride=1) -> CoordinateManager:
        mgr = CoordinateManager.replay(
            self.oplog, coordinates, tensor_stride, cap_floors=self.cap_floors,
            grid_floors=self.grid_floors, device=self.device,
        )
        self.cap_floors.update(mgr._cap_floors)
        self.grid_floors.update(mgr._grid_floors)
        return mgr


class CompiledReplayer:
    """The coordinate phase as one CUDA graph per batch.

    ``trace`` replays the recipe with no host sync (every map at its
    floored capacity); on the card ``run`` captures it once per (capacity
    bucket, D, feature shape and dtype, ``_version``) into a
    ``torch.cuda.CUDAGraph`` that shares one memory pool with its
    siblings.  Per batch, ``run`` copies the coordinates (and features)
    into the graph's static inputs, replays it, and reads every count and
    the ``ok`` flag in ONE host sync; then it cuts the maps to their exact
    rows (copies, so the Geometry outlives the next replay).  On the CPU
    ``trace`` runs the same sync-free replay without a graph.

    When a floor did not hold, ``ok`` is false and ``recover`` replays the
    batch in sync mode, ratchets the floors (over-provisioned by 1.3),
    bumps ``_version`` and drops every graph: a graph captured under the
    old floors would fail its check on every later batch.  ``__call__``
    does both; ``captures`` and ``recoveries`` count them.  A capture or
    launch that fails raises: nothing falls back to the eager path.
    """

    def __init__(self, recorded_manager: CoordinateManager, quantization_mode=None):
        self.oplog = recorded_manager.oplog()
        self.cap_floors = dict(recorded_manager._cap_floors)
        self.grid_floors = dict(recorded_manager._grid_floors)
        self.device = recorded_manager.device
        self.quantization_mode = quantization_mode
        self._version = 0
        self._graphs = {}
        self._pool = None
        self.captures = self.recoveries = 0

    def _invalidate(self):
        self._version += 1
        self._graphs, self._pool = {}, None

    def adopt(self, replayer: GeometryReplayer) -> "CompiledReplayer":
        """Take a warmed ``GeometryReplayer``'s recipe and floors; the graphs
        captured under older floors are dropped."""
        self.oplog = list(replayer.oplog)
        self.cap_floors = dict(replayer.cap_floors)
        self.grid_floors = dict(replayer.grid_floors)
        self._invalidate()
        return self

    def trace(self, coords_padded, n_valid, feats_padded=None):
        """The replay with no host sync: (manager holding padded maps,
        reduced padded features or None, 0-d device bool ``ok``)."""
        mgr = CoordinateManager.replay(
            self.oplog, coords_padded, cap_floors=self.cap_floors, grid_floors=self.grid_floors,
            traced=True, n_valids=[n_valid], device=self.device,
        )
        fp = None
        if feats_padded is not None:
            fp = mgr.reduce_features(mgr._entry_key, feats_padded, self.quantization_mode)
        return mgr, fp, mgr.traced_ok()

    def _outputs(self, static):
        mgr, fp, ok = self.trace(static.coords, static.n, static.feats)
        return mgr, fp, torch.cat([mgr._pending_scalars(), ok.to(torch.int64).reshape(1)])

    def _capture(self, static):
        """Warm the replay on a side stream, then capture it."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._outputs(static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(static.graph, pool=self._pool):
            static.mgr, static.fp, static.scalars = self._outputs(static)
        self.captures += 1

    def run(self, coordinates, features=None):
        """(Geometry, reduced features or None, True) for one batch, or
        (None, None, False) when a floor did not hold: then call
        ``recover``."""
        coords = torch.as_tensor(coordinates)
        n, width = coords.shape
        cap = bucket_capacity(n)
        feats = None if features is None else torch.as_tensor(features)
        fkey = None if feats is None else (tuple(feats.shape[1:]), feats.dtype)
        key = (cap, width, fkey, self._version)
        static = self._graphs.get(key)
        if static is None:
            static = types.SimpleNamespace(
                coords=torch.zeros((cap, width), dtype=torch.int32, device=self.device),
                n=torch.zeros((), dtype=torch.int64, device=self.device),
                feats=None if feats is None else torch.zeros(
                    (cap,) + fkey[0], dtype=feats.dtype, device=self.device),
            )
        static.coords[:n].copy_(coords, non_blocking=True)
        static.n.fill_(n)
        if feats is not None:
            static.feats[:n].copy_(feats, non_blocking=True)
        if self.device.type == "cuda":
            if key not in self._graphs:
                self._capture(static)
                self._graphs[key] = static
            static.graph.replay()
            mgr, fp, scalars = static.mgr, static.fp, static.scalars
        else:
            mgr, fp, scalars = self._outputs(static)
        values = scalars.tolist()  # the one host sync
        if not values[-1]:
            return None, None, False
        exact = mgr._finalized(values[:-1])
        geo = exact.export_geometry()
        if fp is not None:
            fp = fp[: exact.size(geo.entry_key)].clone()
        return geo, fp, True

    def recover(self, coordinates, features=None):
        """Replay a batch whose floors did not hold in sync mode, ratchet
        the floors and drop the stale graphs; returns (Geometry, features)."""
        mgr = CoordinateManager.replay(
            self.oplog, coordinates, cap_floors=self.cap_floors, grid_floors=self.grid_floors,
            deferred=True, overprovision=1.3, device=self.device,
        )
        self.cap_floors.update(mgr._cap_floors)
        self.grid_floors.update(mgr._grid_floors)
        self._invalidate()
        self.recoveries += 1
        geo = mgr.export_geometry()
        fp = None
        if features is not None:
            fp = mgr.reduce_features(geo.entry_key, features, self.quantization_mode)
        return geo, fp

    def __call__(self, coordinates, features=None):
        """(Geometry, features): ``run``, and ``recover`` where a floor did
        not hold or is missing."""
        try:
            geo, fp, ok = self.run(coordinates, features)
        except UntraceableReplay:
            return self.recover(coordinates, features)
        if not ok:
            return self.recover(coordinates, features)
        return geo, fp
