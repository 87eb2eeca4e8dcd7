"""SparseTensor basics (reference: examples/sparse_tensor_basic.py; JAX:
``examples/sparse_tensor_basic.py``): quantization, collation, a
TensorField round trip, dense export and arithmetic across coordinate sets.

Run: python examples_torch/sparse_tensor_basic.py [--cpu]
"""

import runpy
from pathlib import Path
from types import SimpleNamespace

# common.py also puts the repository root, which holds the package, on sys.path
common = SimpleNamespace(**runpy.run_path(str(Path(__file__).resolve().parent / "common.py")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import minkowskiengine_tpu_torch as MT  # noqa: E402
from minkowskiengine_tpu_torch.utils import batched_coordinates, sparse_quantize  # noqa: E402


def main(argv=None):
    args = common.parser(__doc__).parse_args(argv)
    device = common.device_of(args)

    # 1. quantize a float point cloud on the host (native C++ engine)
    rng = np.random.RandomState(0)
    pts = rng.rand(1000, 3) * 5
    feats = rng.randn(1000, 3).astype(np.float32)
    coords, qfeats = sparse_quantize(pts, features=feats, quantization_size=0.2)
    print("quantized:", coords.shape, qfeats.shape)

    # 2. batch several clouds
    bcoords = batched_coordinates([coords, coords[:100]], device=device)
    print("batched:", tuple(bcoords.shape), "batches:", torch.unique(bcoords[:, 0]).tolist())

    # 3. SparseTensor with duplicate-coordinate feature averaging
    dup = torch.tensor([[0, 0, 0], [0, 0, 0], [0, 1, 1]], dtype=torch.int32, device=device)
    f = torch.tensor([[1.0], [3.0], [5.0]], device=device)
    avg = MT.SparseTensor(
        f, dup, quantization_mode=MT.SparseTensorQuantizationMode.UNWEIGHTED_AVERAGE
    )
    print("averaged duplicates:", avg.F.ravel().tolist())

    # 4. TensorField -> sparse -> slice round trip
    fcoords = np.concatenate([np.zeros((1000, 1), np.float32), pts.astype(np.float32) / 0.2], 1)
    tf = MT.TensorField(torch.from_numpy(feats).to(device), torch.from_numpy(fcoords).to(device))
    s = tf.sparse()
    back = s.slice(tf)
    print("field:", tf.shape, "-> sparse:", s.shape, "-> slice:", back.shape)

    # 5. dense export
    small = MT.SparseTensor(
        torch.ones((3, 2), device=device),
        torch.tensor([[0, 0, 0], [0, 1, 2], [0, 2, 1]], dtype=torch.int32, device=device),
    )
    dense, min_c, stride = small.dense()
    print("dense:", tuple(dense.shape))

    # 6. arithmetic across different coordinate sets (union semantics)
    mgr = MT.CoordinateManager(D=2, device=device)
    a = MT.SparseTensor(torch.ones((2, 1), device=device),
                        torch.tensor([[0, 0, 0], [0, 1, 0]], dtype=torch.int32, device=device),
                        coordinate_manager=mgr)
    b = MT.SparseTensor(torch.ones((2, 1), device=device) * 2,
                        torch.tensor([[0, 0, 0], [0, 2, 2]], dtype=torch.int32, device=device),
                        coordinate_manager=mgr)
    c = a + b
    union = {tuple(x): v for x, v in zip(c.C.tolist(), c.F[:, 0].tolist())}
    print("union add:", union)
    return {"quantized": coords.shape, "averaged": avg.F.ravel().tolist(), "field": tf.shape,
            "sparse": s.shape, "slice": back.shape, "dense": tuple(dense.shape), "union": union}


if __name__ == "__main__":
    main()
