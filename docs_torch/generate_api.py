"""Generate the markdown API reference of the PyTorch/CUDA port under
docs_torch/api/ from its docstrings and signatures.

The port's counterpart of ``docs/generate_api.py``, with the same pages
(``PAGES``).  Every public name of the package's top level, ``nn``,
``utils``, ``models``, ``MinkowskiFunctional`` and ``parallel`` lands on a
page: the pages' own entries first, then every other name on the page of
the module that defines it (``HOMES``).  It imports ``torch`` and the port
only, and runs on the CPU; nothing it writes depends on whether a CUDA card
is present.

Run:  python docs_torch/generate_api.py          # rewrites docs_torch/api/*.md
      python docs_torch/generate_api.py --check  # exits 1 if a page is stale
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import pkgutil
import re
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch import models, parallel, utils  # noqa: E402

# every submodule, so that each is bound on its package whatever the
# caller imported before (a page lists the submodules bound on a package)
for _m in pkgutil.walk_packages(MT.__path__, MT.__name__ + "."):
    importlib.import_module(_m.name)

OUT = HERE / "api"
PACKAGE = "minkowskiengine_tpu_torch"
# the modules whose public names the pages cover, as the API surface test
# reads them
PATHS = ("", "nn", "utils", "models", "MinkowskiFunctional", "parallel")

# Page layout: (filename, title, intro, [names resolved on MT, or (label,
# object) pairs]).
PAGES = [
    (
        "sparse_tensor.md",
        "SparseTensor and TensorField",
        "The two tensor types. `SparseTensor` holds integer coordinates and "
        "their features; `TensorField` holds continuous coordinates and "
        "converts to and from sparse tensors (`sparse()`, `splat()`, "
        "`slice`). Both keep their features on the device of the tensor "
        "they were given; a new coordinate manager is placed on the card "
        "unless `device=\"cpu\"` is passed.",
        [
            "SparseTensor",
            "TensorField",
            "SparseTensorOperationMode",
            "SparseTensorQuantizationMode",
            "set_sparse_tensor_operation_mode",
            "sparse_tensor_operation_mode",
            "clear_global_coordinate_manager",
            "global_coordinate_manager",
            "set_global_coordinate_manager",
        ],
    ),
    (
        "coords.md",
        "Coordinate management",
        "Coordinate maps, kernel maps, and the manager that caches them. "
        "Keys are int64 (one word per row up to D = 6, several words "
        "above); kernel maps are dense (K, N) index tables with -1 for no "
        "pair. `Geometry`, `GeometryReplayer` and `CompiledReplayer` export "
        "a manager's maps and replay its coordinate-op recipe on a new "
        "cloud (see docs_torch/PERFORMANCE.md).",
        [
            "CoordinateManager",
            "CoordinateMapKey",
            "CoordsManager",
            "KernelGenerator",
            "KernelRegion",
            "RegionType",
            "CoordinateMapType",
            "GPUMemoryAllocatorType",
            "MinkowskiAlgorithm",
            "Geometry",
            "GeometryReplayer",
            "CompiledReplayer",
            "stack_geometries",
        ],
    ),
    (
        "convolution.md",
        "Convolution",
        "Sparse convolution modules. On the card the generalized sparse "
        "convolution runs two hand-written CUDA kernels: K1 "
        "(`kernels/gather_gemm.py`, the forward, the input gradient and the "
        "transposed conv: gather rows by the kernel map and multiply on the "
        "tensor cores) and K2 (`kernels/conv_dw.py`, the weight gradient). "
        "On the CPU the same calls run their plain PyTorch versions. "
        "`set_compute_dtype(torch.bfloat16)` runs both in bf16 with float32 "
        "sums.",
        [
            "MinkowskiConvolution",
            "MinkowskiConvolutionTranspose",
            "MinkowskiGenerativeConvolutionTranspose",
            "MinkowskiChannelwiseConvolution",
            "MinkowskiConvolutionFunction",
            "MinkowskiConvolutionTransposeFunction",
            "set_compute_dtype",
            "compute_dtype",
        ],
    ),
    (
        "pooling.md",
        "Pooling and serialized attention",
        "Local, global, and direct pooling. Global ops accept a "
        "SparseTensor or a TensorField, as in the reference. Point "
        "Transformer V3's layers: multi-head attention inside windows of a "
        "map's rows along a space-filling curve (the manager's `serialize` "
        "and `window_plan`; on the card the port's fused attention kernel, "
        "on the CPU its plain version), and the serialized pooling pair.",
        [
            "MinkowskiSumPooling",
            "MinkowskiAvgPooling",
            "MinkowskiMaxPooling",
            "MinkowskiPoolingTranspose",
            "MinkowskiGlobalPooling",
            "MinkowskiGlobalSumPooling",
            "MinkowskiGlobalAvgPooling",
            "MinkowskiGlobalMaxPooling",
            "MinkowskiSerializedAttention",
            "MinkowskiSerializedPooling",
            "MinkowskiSerializedUnpooling",
            "PoolingMode",
            "MinkowskiLocalPoolingFunction",
            "MinkowskiLocalPoolingTransposeFunction",
            "MinkowskiGlobalPoolingFunction",
            "MinkowskiDirectMaxPoolingFunction",
        ],
    ),
    (
        "broadcast_prune_union.md",
        "Broadcast, pruning, union, interpolation",
        "",
        [
            "MinkowskiBroadcast",
            "MinkowskiBroadcastAddition",
            "MinkowskiBroadcastMultiplication",
            "MinkowskiBroadcastConcatenation",
            "MinkowskiPruning",
            "MinkowskiUnion",
            "MinkowskiInterpolation",
            "MinkowskiInterpolationFunction",
            "MinkowskiPruningFunction",
            "MinkowskiUnionFunction",
        ],
    ),
    (
        "normalization.md",
        "Normalization",
        "Batch norm over a tensor's rows; `MinkowskiSyncBatchNorm` "
        "all-reduces its statistics over a `torch.distributed` group (or a "
        "mesh axis) once a process group is initialized.",
        [
            "MinkowskiBatchNorm",
            "MinkowskiSyncBatchNorm",
            "MinkowskiInstanceNorm",
            "MinkowskiInstanceNormFunction",
            "MinkowskiStableInstanceNorm",
            "MinkowskiLayerNorm",
        ],
    ),
    (
        "nonlinearity.md",
        "Nonlinearities and ops",
        "Elementwise module wrappers, the functional interface, and "
        "concatenation/linear ops.",
        [
            "MinkowskiReLU",
            "MinkowskiPReLU",
            "MinkowskiSELU",
            "MinkowskiCELU",
            "MinkowskiDropout",
            "MinkowskiAlphaDropout",
            "MinkowskiSoftmax",
            "MinkowskiSigmoid",
            "MinkowskiTanh",
            "MinkowskiAdaptiveLogSoftmaxWithLoss",
            "MinkowskiLinear",
            "cat",
            "mean",
            "var",
            "dense_coordinates",
            "to_sparse",
            "to_sparse_all",
            "MinkowskiNetwork",
            ("MinkowskiFunctional", MT.MinkowskiFunctional),
        ],
    ),
    (
        "sparse_matrix.md",
        "Sparse matrix functions",
        "COO sparse-matrix multiply built on segment reductions.",
        [
            "spmm",
            "spmm_average",
            "MinkowskiSPMMFunction",
            "MinkowskiSPMMAverageFunction",
        ],
    ),
    (
        "utils.md",
        "Utilities",
        "Collation, quantization (with the native host engine), gradcheck, "
        "initialization, summary, checkpointing (`torch.save`), weight "
        "exchange with the reference's state dicts, profiling, the "
        "procedural dataset generators, and the CUDA diagnostics.",
        [
            ("utils.batched_coordinates", utils.batched_coordinates),
            ("utils.sparse_collate", utils.sparse_collate),
            ("utils.batch_sparse_collate", utils.batch_sparse_collate),
            ("utils.sparse_quantize", utils.sparse_quantize),
            ("utils.quantize_label", utils.quantize_label),
            ("utils.gradcheck", utils.gradcheck),
            ("utils.summary", utils.summary),
        ],
    ),
    (
        "parallel.md",
        "Parallelism",
        "Multi-GPU training over a `torch.distributed` device mesh, one "
        "process per rank: data parallelism on a shared geometry or on "
        "each rank's own geometry, tensor (column) parallelism, and "
        "spatial sharding of one large cloud over the ranks (halo "
        "exchange). Every collective goes through `parallel.comm`, which "
        "counts them.",
        [
            ("parallel.make_data_parallel_step", parallel.make_data_parallel_step),
            ("parallel.make_per_device_geometry_step", parallel.make_per_device_geometry_step),
            "spatial_execution",
            "set_spatial_execution",
            ("parallel", parallel),
        ],
    ),
    (
        "models.md",
        "Models",
        "The model zoo: ResNet14/18/34/50/101, MinkUNet14/18/34/50/101 "
        "(+A/B/C/D variants), the classification nets, the "
        "completion/VAE generative nets, Point Transformer V3 and Mask3D "
        "(instance segmentation: `Mask3D`, `SetCriterion`, `HungarianMatcher`). "
        "Every "
        "constructor takes "
        "`generator=` (weights drawn on the CPU, the same on any device) "
        "and `device=`.",
        [("models", models)],
    ),
]

# the page of every other public name, by the module that defines it
# (longest prefix first)
HOMES = [
    ("nn.conv", "convolution.md"),
    ("nn.pooling", "pooling.md"),
    ("nn.broadcast", "broadcast_prune_union.md"),
    ("nn.pruning", "broadcast_prune_union.md"),
    ("nn.union", "broadcast_prune_union.md"),
    ("nn.interpolation", "broadcast_prune_union.md"),
    ("nn.norm", "normalization.md"),
    ("nn.serialized", "pooling.md"),
    ("nn", "nonlinearity.md"),
    ("sparse_matrix_functions", "sparse_matrix.md"),
    ("sparse_tensor", "sparse_tensor.md"),
    ("tensor_field", "sparse_tensor.md"),
    ("tensor", "sparse_tensor.md"),
    ("types", "sparse_tensor.md"),
    ("coords", "coords.md"),
    ("kernel_generator", "coords.md"),
    ("kernels", "convolution.md"),
    ("ops", "convolution.md"),
    ("config", "convolution.md"),
    ("utils", "utils.md"),
    ("diagnostics", "utils.md"),
    ("parallel", "parallel.md"),
    ("models", "models.md"),
    ("modules", "models.md"),
]


def public_names(module, package: str):
    """The public names of ``module``: its classes, functions and values,
    and the package's own submodules bound on it (the API surface test's
    rule)."""
    out = []
    for name in dir(module):
        if name.startswith("_"):
            continue
        value = getattr(module, name)
        if isinstance(value, types.ModuleType):
            if value.__name__ != f"{package}.{name}" and name != "MinkowskiFunctional":
                continue
        out.append(name)
    return out


def _module_at(path: str):
    mod = MT
    for part in filter(None, path.split(".")):
        mod = getattr(mod, part)
    return mod


def _home(obj) -> str | None:
    where = obj.__name__ if isinstance(obj, types.ModuleType) else getattr(obj, "__module__", "")
    if not where or not where.startswith(PACKAGE):
        return None
    rel = where[len(PACKAGE) + 1:]
    for prefix, page in HOMES:
        if rel == prefix or rel.startswith(prefix + "."):
            return page
    raise KeyError(f"no page for {where}: add it to HOMES")


def _entries():
    """Every page's entries: its own, then every other public name of PATHS
    on its home page, each object once."""
    pages = {fname: [e if isinstance(e, tuple) else (e, getattr(MT, e)) for e in entries]
             for fname, _, _, entries in PAGES}
    placed = {id(obj) for entries in pages.values() for _, obj in entries}
    for entries in pages.values():  # a page's own module entries list their members
        placed |= {id(m) for _, obj in entries if isinstance(obj, types.ModuleType)
                   for _, m in _members(obj)}
    for path in PATHS:
        mod = _module_at(path)
        for name in public_names(mod, mod.__name__ if path else PACKAGE):
            obj = getattr(mod, name)
            page = _home(obj)
            if page is None or id(obj) in placed:
                continue
            placed.add(id(obj))
            pages[page].append((f"{path}.{name}" if path else name, obj))
    return pages


def _members(module):
    """(name, object) of a module's public classes and functions that the
    package defines."""
    out = []
    for mname in sorted(getattr(module, "__all__", dir(module))):
        member = getattr(module, mname, None)
        if mname.startswith("_") or not (inspect.isclass(member) or inspect.isfunction(member)):
            continue
        if getattr(member, "__module__", "").startswith(PACKAGE):
            out.append((mname, member))
    return out


_ADDRESS = re.compile(r" at 0x[0-9a-f]+")


def _sig(obj):
    try:
        return _ADDRESS.sub("", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return ""


def _doc(obj):
    return inspect.getdoc(obj) or ""


def _emit_object(lines, name, obj, listed=True):
    if inspect.isclass(obj):
        lines.append(f"### `{name}`\n")
        init = vars(obj).get("__init__") or next(
            (vars(b).get("__init__") for b in obj.__mro__[1:-1] if vars(b).get("__init__")),
            None,
        )
        sig = _sig(init) if init else ""
        if sig:
            sig = sig.replace("(self, ", "(").replace("(self)", "()")
            lines.append(f"```python\n{name}{sig}\n```\n")
        if _doc(obj):
            lines.append(_doc(obj) + "\n")
        # public methods with docstrings, declared on the class itself
        for mname, meth in sorted(vars(obj).items()):
            if mname.startswith("_") and mname != "__call__":
                continue
            if isinstance(meth, (staticmethod, classmethod)):
                meth = meth.__func__
            if not callable(meth) and not isinstance(meth, property):
                continue
            target = meth.fget if isinstance(meth, property) else meth
            mdoc = _doc(target)
            if not mdoc or mdoc == "Call self as a function.":
                continue
            msig = "" if isinstance(meth, property) else _sig(target)
            msig = msig.replace("(self, ", "(").replace("(self)", "()")
            prop = "  *(property)*" if isinstance(meth, property) else ""
            lines.append(f"**`{name}.{mname}{msig}`**{prop}\n")
            lines.append(mdoc + "\n")
    elif isinstance(obj, types.ModuleType):
        rel = obj.__name__[len(PACKAGE) + 1:]
        lines.append(f"### module `{name}`" + (f" (`{rel}`)" if rel != name else "") + "\n")
        if _doc(obj):
            lines.append(_doc(obj) + "\n")
        members = [f"- `{name}.{mname}` — {(_doc(m).splitlines() or [''])[0]}"
                   for mname, m in (_members(obj) if listed else ())]
        if members:
            lines.append("\n".join(members) + "\n")
    elif callable(obj):
        lines.append(f"### `{name}{_sig(obj)}`\n")
        if _doc(obj):
            lines.append(_doc(obj) + "\n")
    else:
        lines.append(f"### `{name}`\n")
        lines.append(f"A value of type `{type(obj).__name__}`.\n")


def render():
    """{file name: text} of every page and the index."""
    pages = _entries()
    out = {}
    index = [
        "# API reference (PyTorch/CUDA port)",
        "",
        "Generated from docstrings by `python docs_torch/generate_api.py`; do not",
        "edit the files in this directory by hand.",
        "",
    ]
    for fname, title, intro, _ in PAGES:
        lines = [f"# {title}\n", "<!-- generated by docs_torch/generate_api.py -->\n"]
        if intro:
            lines.append(intro + "\n")
        own = len([e for p in PAGES if p[0] == fname for e in p[3]])
        for i, (name, obj) in enumerate(pages[fname]):
            # modules placed by HOMES: their docstring; their names are listed on their own
            _emit_object(lines, name, obj, listed=i < own)
        out[fname] = "\n".join(lines).rstrip() + "\n"
        index.append(f"- [{title}]({fname})")
    out["index.md"] = "\n".join(index) + "\n"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Write (or check) docs_torch/api/*.md.")
    p.add_argument("--check", action="store_true",
                   help="write nothing; exit 1 if a page differs from what would be written")
    args = p.parse_args(argv)
    pages = render()
    if args.check:
        stale = [f for f, text in pages.items()
                 if not (OUT / f).is_file() or (OUT / f).read_text() != text]
        stale += sorted(p.name for p in OUT.glob("*.md") if p.name not in pages)
        for f in stale:
            print(f"stale: docs_torch/api/{f}", file=sys.stderr)
        return 1 if stale else 0
    OUT.mkdir(exist_ok=True)
    for f, text in pages.items():
        (OUT / f).write_text(text)
        print(f"wrote docs_torch/api/{f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
