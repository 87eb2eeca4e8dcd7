"""Port parity for the generative slice: the generative transposed conv,
CompletionNet and the VAE equal JAX's on the CPU.

Narrow models (3 levels, the channels of the JAX package's own tests) on
``completion_batch`` at resolution 32 with two shapes; the weights are
exported from the JAX model and loaded through the port's loader.  The JAX
model runs once per module fixture: its first run compiles every op shape
(about a minute on the CPU).

The JAX package's ``export_reference_state_dict`` stops at an ``nnx.List``
of this flax version (it sorts the list's integer attributes with the
module's names), so ``_jax_named`` walks the lists itself and names each
element ``<list>.<i>``: the names the exporter gives a list.

Tolerances, per tensor, max|Δ| / max|ref|: 1e-5 for the generative conv's
features and gradients and for each level's logits (f32 sums in another
order through at most ~20 layers, each ~1e-7 relative); 1e-4 for the loss,
every parameter gradient and the weights after one SGD step, as the other
training parity tests: batch norm's backward amplifies the forward's
rounding.  Coordinates, keys, target masks and keep masks are bit-equal.

The bf16 cases at the end run both packages under ``set_compute_dtype(bf16)``,
every run held to JAX's bf16 keep masks; their rule (BF16_FACTOR, BF16_FLOOR)
is stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models import CompletionNet as JCompletionNet
from minkowskiengine_tpu.models import VAE as JVAE
from minkowskiengine_tpu.nn.conv import (
    MinkowskiGenerativeConvolutionTranspose as JGenerative,
)
from minkowskiengine_tpu.nn.norm import MinkowskiBatchNorm as JBatchNorm
from minkowskiengine_tpu.utils.torch_import import reference_named_params
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import VAE, CompletionNet
from minkowskiengine_tpu_torch.nn.norm import MinkowskiBatchNorm
from minkowskiengine_tpu_torch.utils.datasets import completion_batch
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference

FEAT_REL, TRAIN_REL = 1e-5, 1e-4
NARROW = (4, 8, 8, 16)  # tests/test_generative.py's SMALL, cut to 3 levels
RES, SHAPES, POINTS = 32, 2, 5000
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_named(module, prefix=""):
    """{reference name: leaf} of a JAX model, lists included."""
    out = {}
    attrs = sorted((k, v) for k, v in vars(module).items()
                   if isinstance(k, str) and not k.startswith("_"))
    for name, child in attrs:
        path = prefix + name
        if isinstance(child, nnx.List):
            for i, sub in enumerate(child):
                out.update(reference_named_params(sub, f"{path}.{i}"))
        elif isinstance(child, nnx.Module):
            if any(isinstance(v, nnx.List) for k, v in vars(child).items() if k != "layers"):
                out.update(_jax_named(child, path + "."))
            else:
                out.update(reference_named_params(child, path))
    return out


def _export(jnet):
    return {k: np.asarray(leaf["to_ref"](np.asarray(leaf["var"][...])))
            for k, leaf in _jax_named(jnet).items()}


def _pair(jnet, tnet, seed=0):
    """The JAX net's weights, with random batch-norm statistics, in both."""
    rng = np.random.RandomState(seed)
    named = _jax_named(jnet)
    sd = _export(jnet)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.randn(*sd[k].shape).astype(np.float32) * 0.1
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
        else:
            continue
        named[k]["var"][...] = jnp.asarray(named[k]["from_ref"](sd[k]))
    sd.update({k: np.asarray(0) for k in tnet.state_dict() if k.endswith("num_batches_tracked")})
    load_state_dict_from_reference(tnet, sd)
    return sd


def _jax_bn(jnet, training):
    for _, m in nnx.iter_graph(jnet):
        if isinstance(m, JBatchNorm):
            m.train(training)


@pytest.fixture(scope="module")
def batch():
    return completion_batch(SHAPES, RES, seed=0, n_points=POINTS)


def _inputs(batch):
    """(JAX manager, input, target key), (port manager, input, target key)."""
    partial, feats, full = batch
    jm = ME.CoordinateManager(D=3)
    jx = ME.SparseTensor(jnp.asarray(feats), partial, coordinate_manager=jm)
    jt, _ = jm.insert_and_map(full, 1)
    tm = MT.CoordinateManager(D=3, device="cpu")
    tx = MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(partial), coordinate_manager=tm)
    tt, _ = tm.insert_and_map(torch.from_numpy(full), 1)
    return (jm, jx, jt), (tm, tx, tt)


def _bce(logits, target):
    return torch.nn.functional.binary_cross_entropy_with_logits(logits, target.to(logits.dtype))


def test_completion_batch_is_deterministic_and_cropped():
    a = completion_batch(3, RES, seed=4, n_points=POINTS)
    b = completion_batch(3, RES, seed=4, n_points=POINTS)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    partial, feats, full = a
    assert partial.dtype == full.dtype == np.int32 and feats.dtype == np.float32
    assert np.all(feats == 1.0) and feats.shape == (len(partial), 1)
    assert np.all(partial[:, 1] < RES / 2) and np.any(full[:, 1] >= RES / 2)
    assert full[:, 1:].min() >= 0 and full[:, 1:].max() < RES
    np.testing.assert_array_equal(partial, full[full[:, 1] < RES / 2])
    assert len(np.unique(full, axis=0)) == len(full)
    assert set(np.unique(full[:, 0])) == {0, 1, 2}
    assert not np.array_equal(completion_batch(3, RES, seed=5, n_points=POINTS)[2], full)


def test_completion_points_saturate_the_voxels():
    """The default point count: doubling it adds under 2% more voxels to a
    batch at a 128³ resolution."""
    n = completion_batch(4, 128, seed=0)[2].shape[0]
    n2 = completion_batch(4, 128, seed=0, n_points=2 * MT.utils.datasets.COMPLETION_POINTS)[2].shape[0]
    assert n <= n2 < 1.02 * n


@pytest.mark.parametrize("k", [2, 4])
def test_generative_transpose_matches_jax(k):
    """Coordinates at stride 4 expand to stride 2 at every offset, even
    where the input's lineage has a map at stride 2; output map, key,
    features and the gradients of input and kernel against JAX."""
    partial = completion_batch(SHAPES, 16, seed=1, n_points=2000)[0]
    jm, tm = ME.CoordinateManager(D=3), MT.CoordinateManager(D=3, device="cpu")
    j1 = jm.insert_and_map(partial, 1)[0]
    t1 = tm.insert_and_map(torch.from_numpy(partial), 1)[0]
    jm.stride(j1, 2)  # a map of the same lineage at the output stride
    tm.stride(t1, 2)
    jk, tk = jm.stride(j1, 4), tm.stride(t1, 4)
    rng = np.random.RandomState(k)
    x = rng.randn(tm.size(tk), 3).astype(np.float32)
    jconv = JGenerative(3, 5, kernel_size=k, stride=2, dimension=3, rngs=nnx.Rngs(k))
    tconv = MT.MinkowskiGenerativeConvolutionTranspose(3, 5, kernel_size=k, stride=2, dimension=3,
                                                       device="cpu")
    load_state_dict_from_reference(tconv, {"kernel": np.asarray(jconv.kernel[...])})
    assert tconv.kernel.shape == (k**3, 3, 5)

    tx = torch.from_numpy(x).requires_grad_()
    tout = tconv(MT.SparseTensor(tx, coordinate_map_key=tk, coordinate_manager=tm))
    g = rng.randn(*tout.F.shape).astype(np.float32)
    seen = {}

    def jloss(conv, xf):
        out = conv(ME.SparseTensor(xf, coordinate_map_key=jk, coordinate_manager=jm))
        seen["key"], seen["coords"] = out.coordinate_map_key.get_key(), np.asarray(out.C)
        return jnp.sum(out.F * jnp.asarray(g)), out.F

    (_, jf), (jg_conv, jg_x) = nnx.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jconv, jnp.asarray(x)
    )
    key = tout.coordinate_map_key.get_key()
    assert key == seen["key"]
    assert key[0] == (2, 2, 2) and key[1].startswith("map-")  # a fresh id beside ((2,)*3, '')
    np.testing.assert_array_equal(tout.C.numpy(), seen["coords"])
    assert tout.size > tm.size(tk)  # generated, not the existing stride-2 map
    assert _rel(tout.F.detach().numpy(), jf) <= FEAT_REL
    (tout.F * torch.from_numpy(g)).sum().backward()
    assert _rel(tx.grad.numpy(), jg_x) <= FEAT_REL
    assert _rel(tconv.kernel.grad.numpy(), jg_conv.kernel[...]) <= FEAT_REL


@pytest.fixture(scope="module")
def completion(batch):
    """One training step of both nets in train mode, with everything the
    tests compare: the forward (per-level logits, targets, keys, coordinates,
    the final map), the loss and gradients, the weights after an SGD step
    with momentum and weight decay."""
    jnet = JCompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, rngs=nnx.Rngs(0))
    tnet = CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, device="cpu")
    sd = _pair(jnet, tnet)
    (jm, jx, jt), (tm, tx, tt) = _inputs(batch)
    _jax_bn(jnet, True)
    jnet.train()
    tnet.train()
    seen = {}

    def loss_fn(m):
        out_cls, targets, final = m(jx, jt)
        seen["keys"] = [c.coordinate_map_key.get_key() for c in out_cls]
        seen["coords"] = [np.asarray(c.C) for c in out_cls]
        seen["targets"] = [np.asarray(t) for t in targets]
        seen["final"] = (final.coordinate_map_key.get_key(), np.asarray(final.C))
        loss = 0.0
        for cls, tgt in zip(out_cls, targets):
            loss = loss + optax.sigmoid_binary_cross_entropy(cls.F[:, 0], tgt.astype(jnp.float32)).mean()
        return loss / len(out_cls), [c.F for c in out_cls]

    (jloss, jlogits), jgrads = nnx.value_and_grad(loss_fn, has_aux=True)(jnet)
    named = nnx.clone(jnet)
    nnx.update(named, jgrads)
    jgrad_sd = _export(named)
    tx_opt = optax.chain(optax.add_decayed_weights(WD), optax.sgd(LR, momentum=MOMENTUM))
    nnx.Optimizer(jnet, tx_opt, wrt=nnx.Param).update(jnet, jgrads)

    out_cls, targets, final = tnet(tx, tt)
    tloss = sum(_bce(c.F[:, 0], t) for c, t in zip(out_cls, targets)) / len(out_cls)
    opt = torch.optim.SGD(tnet.parameters(), lr=LR, momentum=MOMENTUM, weight_decay=WD)
    opt.zero_grad()
    tloss.backward()
    tgrads = {k: p.grad.clone() for k, p in tnet.named_parameters()}
    opt.step()
    return dict(
        jnet=jnet, tnet=tnet, sd=sd, seen=seen, jloss=float(jloss), jlogits=jlogits,
        jgrads=jgrad_sd, tloss=tloss.item(), out_cls=out_cls, targets=targets, final=final,
        tgrads=tgrads, tm=tm,
    )


def test_completion_state_dict_names_are_jax_names(completion):
    sd, tnet = completion["sd"], completion["tnet"]
    assert set(tnet.state_dict()) == set(sd)
    for name in ("enc_first.0.kernel", "enc_blocks.2.4.bn.weight", "dec_blocks.0.0.kernel",
                 "cls_heads.2.bias", "dec_blocks.1.3.kernel"):
        assert name in sd, name
    assert tnet.dec_blocks[0][0].kernel.shape == (64, NARROW[-1], NARROW[-2])  # k = 4
    assert tuple(np.shape(sd["cls_heads.2.bias"])) == (1,)  # reference layout (C,)


def test_completion_train_forward_matches_jax(completion):
    """Every level: the map's key and coordinates, the target mask and the
    logits; the keep masks (logit > 0 or target); the pruned final map."""
    seen, out_cls, targets = completion["seen"], completion["out_cls"], completion["targets"]
    assert len(out_cls) == len(seen["keys"]) == 3
    for i, (cls, tgt) in enumerate(zip(out_cls, targets)):
        assert cls.coordinate_map_key.get_key() == seen["keys"][i]
        np.testing.assert_array_equal(cls.C.numpy(), seen["coords"][i])
        np.testing.assert_array_equal(tgt.numpy(), seen["targets"][i])
        want = np.asarray(completion["jlogits"][i])
        got = cls.F.detach().numpy()
        assert _rel(got, want) <= FEAT_REL, i
        keep = (want[:, 0] > 0) | seen["targets"][i]
        np.testing.assert_array_equal((got[:, 0] > 0) | tgt.numpy(), keep)
        assert tgt.any() and (~tgt).any() and not keep.all()
    assert [k[1] for k in seen["keys"]] == ["merged"] * 3
    key, coords = seen["final"]
    assert completion["final"].coordinate_map_key.get_key() == key
    np.testing.assert_array_equal(completion["final"].C.numpy(), coords)
    assert [k[1] for k in completion["tm"]._maps][:2] == ["", "map-0"]


def test_completion_loss_gradients_and_sgd_step_match_jax(completion):
    jloss, tloss = completion["jloss"], completion["tloss"]
    assert abs(tloss - jloss) <= TRAIN_REL * abs(jloss)
    want, tgrads = completion["jgrads"], completion["tgrads"]
    assert len(tgrads) == len([k for k in want if not k.endswith(("running_mean", "running_var"))])
    for name, g in tgrads.items():
        assert np.abs(want[name]).max() > 0, name  # every parameter is reached
        assert _rel(g.numpy().reshape(np.shape(want[name])), want[name]) <= TRAIN_REL, name
    jsd = _export(completion["jnet"])
    for name, v in completion["tnet"].state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert _rel(v.numpy().reshape(np.shape(jsd[name])), jsd[name]) <= TRAIN_REL, name


def test_completion_eval_matches_jax(batch):
    """Eval mode: running statistics in the batch norms, and a row is kept
    only where its logit is > 0."""
    jnet = JCompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, rngs=nnx.Rngs(1))
    tnet = CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, device="cpu")
    _pair(jnet, tnet, seed=1)
    jnet.eval()
    _jax_bn(jnet, False)  # JAX's CompletionNet.eval() leaves them in train mode
    tnet.eval()
    (_, jx, jt), (_, tx, tt) = _inputs(batch)
    jcls, jtargets, jfinal = jnet(jx, jt)
    with torch.no_grad():
        tcls, ttargets, tfinal = tnet(tx, tt)
    for j, t, jtg, ttg in zip(jcls, tcls, jtargets, ttargets):
        assert t.coordinate_map_key.get_key() == j.coordinate_map_key.get_key()
        np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
        np.testing.assert_array_equal(ttg.numpy(), np.asarray(jtg))
        assert _rel(t.F.numpy(), j.F) <= FEAT_REL
    assert tfinal.coordinate_map_key.get_key() == jfinal.coordinate_map_key.get_key()
    np.testing.assert_array_equal(tfinal.C.numpy(), np.asarray(jfinal.C))
    assert tfinal.size <= tcls[-1].size


def test_eval_puts_the_batch_norms_in_eval_mode():
    """Pins the queue-3 divergence: the port's ``eval()`` is torch's and
    reaches every batch norm, as in the reference; JAX's CompletionNet and
    Decoder override ``eval()`` to switch the keep rule only."""
    tnet = CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, device="cpu").eval()
    assert not tnet.training
    assert all(not m.training for m in tnet.modules() if isinstance(m, MinkowskiBatchNorm))
    jnet = JCompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, rngs=nnx.Rngs(0))
    jnet.eval()
    assert not jnet.training
    assert all(m.training for _, m in nnx.iter_graph(jnet) if isinstance(m, JBatchNorm))


@pytest.fixture(scope="module")
def vae_pair():
    jnet = JVAE(channels=NARROW, in_nchannel=1, resolution=RES, rngs=nnx.Rngs(3))
    tnet = VAE(channels=NARROW, in_nchannel=1, resolution=RES, device="cpu")
    sd = _pair(jnet, tnet, seed=3)
    return jnet, tnet, sd


def test_vae_state_dict_names_are_jax_names(vae_pair):
    _, tnet, sd = vae_pair
    assert set(tnet.state_dict()) == set(sd)
    for name in ("encoder.linear_mean.linear.weight", "encoder.blocks.3.4.bn.weight",
                 "decoder.blocks.2.3.kernel", "decoder.cls_heads.0.bias"):
        assert name in sd, name


def test_vae_encoder_and_decoder_match_jax(vae_pair, batch):
    """The encoder's mean and log-variance; then the decoder, in train mode
    (batch norms too), fed the same z on the seed voxels at stride
    2**4 = 16: per-level keys, coordinates, targets and logits, and the
    generated map, which ends at stride 2 as in JAX."""
    jnet, tnet, _ = vae_pair
    _, _, full = batch
    feats = np.ones((len(full), 1), np.float32)
    (jm, jx, jt), (tm, tx, tt) = _inputs((full, feats, full))
    _jax_bn(jnet, True)
    jnet.decoder.train()
    tnet.train()
    jmean, jlogvar = jnet.encoder(jx)
    tmean, tlogvar = tnet.encoder(tx)
    assert tmean.F.shape == (SHAPES, NARROW[-1])
    np.testing.assert_array_equal(tmean.C.numpy(), np.asarray(jmean.C))
    assert _rel(tmean.F.detach().numpy(), jmean.F) <= FEAT_REL
    assert _rel(tlogvar.F.detach().numpy(), jlogvar.F) <= FEAT_REL

    eps = np.random.RandomState(7).randn(SHAPES, NARROW[-1]).astype(np.float32)
    jz = jmean.F + jnp.asarray(eps) * jnp.exp(0.5 * jlogvar.F)
    stride0 = jnet.decoder_resolution_stride(jx)
    assert tnet.decoder_resolution_stride(tx) == tuple(stride0) == (16, 16, 16)
    jseed, _ = jm.insert_and_map(np.asarray(jmean.C), stride0)
    jcls, jtargets, jout = jnet.decoder(
        ME.SparseTensor(jz, coordinate_map_key=jseed, coordinate_manager=jm), jt
    )
    tz = torch.from_numpy(np.array(jz))
    tcls, ttargets, tout = tnet.decoder(tnet.seed(tx, tmean, tz), tt)
    assert len(tcls) == len(NARROW) - 1
    for j, t, jtg, ttg in zip(jcls, tcls, jtargets, ttargets):
        assert t.coordinate_map_key.get_key() == j.coordinate_map_key.get_key()
        np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
        np.testing.assert_array_equal(ttg.numpy(), np.asarray(jtg))
        want, got = np.asarray(j.F), t.F.detach().numpy()
        assert _rel(got, want) <= FEAT_REL
        np.testing.assert_array_equal((got[:, 0] > 0) | ttg.numpy(), (want[:, 0] > 0) | np.asarray(jtg))
    assert tout.tensor_stride == tuple(jout.tensor_stride) == (2, 2, 2)
    np.testing.assert_array_equal(tout.C.numpy(), np.asarray(jout.C))


def test_vae_forward_draws_its_noise_from_the_generator(batch):
    _, _, full = batch
    net = VAE(channels=NARROW, in_nchannel=1, resolution=RES, device="cpu",
              generator=torch.Generator().manual_seed(0)).eval()
    runs = []
    for _ in range(2):
        tm = MT.CoordinateManager(D=3, device="cpu")
        x = MT.SparseTensor(torch.ones(len(full), 1), torch.from_numpy(full), coordinate_manager=tm)
        tt, _ = tm.insert_and_map(torch.from_numpy(full), 1)
        with torch.no_grad():
            runs.append(net(x, tt, generator=torch.Generator().manual_seed(5)))
    (cls0, tg0, out0, mean0, lv0), (cls1, _, out1, _, _) = runs
    assert mean0.F.shape == lv0.F.shape == (SHAPES, NARROW[-1])
    assert len(cls0) == len(tg0) == 3
    for a, b in zip(cls0, cls1):
        torch.testing.assert_close(a.F, b.F, rtol=0, atol=0)
    assert out0.tensor_stride == (2, 2, 2) and torch.equal(out0.C, out1.C)


def test_models_default_to_the_card():
    builders = [
        lambda: CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW),
        lambda: VAE(channels=NARROW),
    ]
    for build in builders:
        if torch.cuda.is_available():
            assert next(build().parameters()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()


# ---------------------------------------------------------------------------
# bf16: both packages under ``set_compute_dtype(bf16)``
# ---------------------------------------------------------------------------
#
# A decoder level keeps the rows whose logit is > 0 (or, in train mode, that
# are targets), so bf16 rounding flips a few rows near 0 and from there the
# runs would be on different maps.  JAX's bf16 run goes first, as it is, and
# its keep masks are read from its logits and targets; the port's bf16 run
# and its float32 run are then held to those masks by a test-side pruning
# (``HeldPruning``).  A row may differ only where the port's logit lies
# within the level's bf16-to-float32 distance of 0 (the larger of the two
# packages' bf16 runs' distances from the port's float32 run); the count is
# printed.  Keys, coordinates and target masks are then bit-equal at every
# level.  The port's bf16 logits, loss and gradients are judged against its
# float32 run on the same masks, with JAX's bf16 run as the yardstick, as in
# test_torch_train_bf16.py: the port's distance, max |Δ| / max |ref| per
# tensor, within BF16_FACTOR times JAX's, or BF16_FLOOR (one bf16 ulp),
# whichever is larger.

BF16_FACTOR, BF16_FLOOR = 4.0, 2.0**-7


@pytest.fixture(scope="module")
def bf16_policy():
    """Sets the policy in both packages (True: bf16, False: None); resets
    both to None after the module."""
    def on(flag):
        ME.set_compute_dtype(jnp.bfloat16 if flag else None)
        MT.set_compute_dtype(torch.bfloat16 if flag else None)
    yield on
    on(False)


class HeldPruning(MT.MinkowskiPruning):
    """Prunes level i to ``masks[i]``, whatever the model's own keep mask
    says; records the levels it pruned, where that mask differed and the
    model's logits.  A level is pruned where the model's own mask keeps a
    row, so the levels pruned must be those where ``masks`` keeps one."""

    def __init__(self, model, masks):
        super().__init__()
        self.masks, self.logits, self.differ, self.pruned = masks, [], {}, []
        for head in model.cls_heads:
            head.register_forward_hook(
                lambda m, a, o: self.logits.append(o.F.detach()[:, 0].double().numpy()))

    def forward(self, input, mask):
        level = len(self.logits) - 1
        held = torch.from_numpy(self.masks[level])
        self.differ[level] = (mask != held).numpy()
        self.pruned.append(level)
        return super().forward(input, held)

    def check_levels(self):
        assert self.pruned == [i for i, m in enumerate(self.masks) if m.any()], self.pruned
        for level, logits in enumerate(self.logits):  # unpruned: every row dropped by both
            self.differ.setdefault(level, logits > 0)


def _f64(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _bf16_judge(port, jaxb, ref, what):
    """Per name: the port's bf16 distance from ``ref`` (its float32 run)
    within BF16_FACTOR times JAX's, or BF16_FLOOR."""
    ratios = {}
    for k in ref:
        d_port, d_jax = _rel(port[k], ref[k]), _rel(jaxb[k], ref[k])
        ratios[k] = (d_port / max(BF16_FACTOR * d_jax, BF16_FLOOR), d_port, d_jax)
        assert d_port <= max(BF16_FACTOR * d_jax, BF16_FLOOR), (what, k, d_port, d_jax)
    worst = max(ratios, key=lambda k: ratios[k][0])
    print(f"{what}: {len(ratios)} judged; closest to its bound {worst}: port {ratios[worst][1]:.2e}, "
          f"JAX {ratios[worst][2]:.2e} from the port's float32 run ({ratios[worst][0]:.2f} of the bound)")


def _held_flips(runs, jlogits, tag):
    """Per level, the rows where a port run's own keep mask left JAX's: each
    such logit within the level's bf16-to-float32 distance of 0."""
    bf16, f32 = runs["bf16"], runs["f32"]
    for level, j in enumerate(jlogits):
        ref = f32.logits[level]
        apart = max(_rel(bf16.logits[level], ref), _rel(_f64(j)[:, 0], ref))
        for name, run in runs.items():
            d = run.differ[level]
            margin = np.abs(run.logits[level][d]).max(initial=0) / np.abs(run.logits[level]).max()
            print(f"{tag} level {level}, port {name}: keep mask differs from JAX bf16 on "
                  f"{int(d.sum())} of {d.size} rows, logit within {margin:.2e} of 0 "
                  f"(the level's bf16-to-float32 distance {apart:.2e})")
            assert margin <= apart, (tag, name, level, margin, apart)


def _jax_completion_bf16(batch, training, seed):
    """JAX's CompletionNet under the bf16 policy (the policy already set):
    the weights, its per-level logits, targets, keys, coordinates, keep
    masks and final map, and in train mode the loss (logits cast to
    float32 before the BCE) and its gradients."""
    jnet = JCompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW,
                          rngs=nnx.Rngs(seed))
    tnet = CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, device="cpu")
    sd = _pair(jnet, tnet, seed=seed)
    (_, jx, jt), _ = _inputs(batch)
    jnet.train(training)
    _jax_bn(jnet, training)
    seen = {}

    def loss_fn(m):
        out_cls, targets, final = m(jx, jt)
        assert all(c.F.dtype == jnp.bfloat16 for c in out_cls)
        seen["keys"] = [c.coordinate_map_key.get_key() for c in out_cls]
        seen["coords"] = [np.asarray(c.C) for c in out_cls]
        seen["targets"] = [np.asarray(t) for t in targets]
        seen["final"] = (final.coordinate_map_key.get_key(), np.asarray(final.C))
        loss = sum(optax.sigmoid_binary_cross_entropy(c.F[:, 0].astype(jnp.float32),
                                                      t.astype(jnp.float32)).mean()
                   for c, t in zip(out_cls, targets))
        return loss / len(out_cls), [c.F for c in out_cls]

    if training:
        (loss, logits), grads = nnx.value_and_grad(loss_fn, has_aux=True)(jnet)
        named = nnx.clone(jnet)
        nnx.update(named, grads)
        seen["loss"], seen["grads"] = float(loss), _export(named)
    else:
        _, logits = loss_fn(jnet)
    seen["logits"] = logits
    seen["masks"] = [(np.asarray(c, np.float32)[:, 0] > 0) | (t if training else False)
                     for c, t in zip(logits, seen["targets"])]
    return sd, seen


def _port_completion_held(sd, batch, masks, training):
    """The port's CompletionNet (under whatever policy is set) held to
    ``masks``: (pruning record, logits, targets, final, loss, gradients)."""
    tnet = CompletionNet(resolution=RES, enc_channels=NARROW, dec_channels=NARROW, device="cpu")
    load_state_dict_from_reference(tnet, sd)
    tnet.train(training)
    tnet.pruning = held = HeldPruning(tnet, masks)
    _, (_, tx, tt) = _inputs(batch)
    with torch.set_grad_enabled(training):
        out_cls, targets, final = tnet(tx, tt)
    held.check_levels()
    loss, grads = None, None
    if training:
        loss = sum(_bce(c.F[:, 0].float(), t) for c, t in zip(out_cls, targets)) / len(out_cls)
        loss.backward()
        loss, grads = loss.item(), {k: p.grad.clone() for k, p in tnet.named_parameters()}
        assert all(g.dtype == torch.float32 for g in grads.values())
    return held, out_cls, targets, final, loss, grads


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_completion_bf16_matches_jax_on_held_masks(bf16_policy, batch, training):
    """JAX's bf16 CompletionNet sets the keep masks; the port's bf16 and
    float32 runs on them: per level keys, coordinates and targets bit-equal,
    the final map JAX's, the bf16 logits (and in train mode the loss and
    every parameter gradient) within BF16_FACTOR of JAX's bf16 distance from
    the port's float32 run."""
    bf16_policy(True)
    sd, seen = _jax_completion_bf16(batch, training, seed=2 if training else 4)
    runs = {}
    for name, flag in (("bf16", True), ("f32", False)):
        bf16_policy(flag)
        runs[name] = _port_completion_held(sd, batch, seen["masks"], training)
    bf16_policy(True)
    _held_flips({k: v[0] for k, v in runs.items()}, seen["logits"],
                "train" if training else "eval")
    for name, (_, out_cls, targets, final, _, _) in runs.items():
        assert all(c.F.dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
                   for c in out_cls)
        for i, (c, t) in enumerate(zip(out_cls, targets)):
            assert c.coordinate_map_key.get_key() == seen["keys"][i]
            np.testing.assert_array_equal(c.C.numpy(), seen["coords"][i])
            np.testing.assert_array_equal(t.numpy(), seen["targets"][i])
        assert final.coordinate_map_key.get_key() == seen["final"][0]
        np.testing.assert_array_equal(final.C.numpy(), seen["final"][1])
    port, ref = runs["bf16"], runs["f32"]
    levels = range(len(seen["logits"]))
    _bf16_judge({i: _f64(port[1][i].F) for i in levels}, {i: _f64(seen["logits"][i]) for i in levels},
                {i: _f64(ref[1][i].F) for i in levels}, "logits")
    if training:
        _bf16_judge({"loss": port[4]}, {"loss": seen["loss"]}, {"loss": ref[4]}, "loss")
        want = seen["grads"]
        _bf16_judge({k: _f64(g).reshape(np.shape(want[k])) for k, g in port[5].items()},
                    {k: want[k] for k in port[5]},
                    {k: _f64(g).reshape(np.shape(want[k])) for k, g in ref[5].items()},
                    "gradients")


def test_vae_bf16_encoder_and_decoder_match_jax(bf16_policy, vae_pair, batch):
    """The VAE under bf16: the encoder's mean and log-variance, then the
    decoder in train mode fed one bf16 z on the seed voxels, JAX's bf16
    decoder setting the keep masks; per level keys, coordinates and targets
    bit-equal, the bf16 logits judged as CompletionNet's."""
    jnet, _, sd = vae_pair
    _, _, full = batch
    feats = np.ones((len(full), 1), np.float32)
    bf16_policy(True)
    (jm, jx, jt), _ = _inputs((full, feats, full))
    _jax_bn(jnet, True)
    jnet.decoder.train()
    jmean, jlogvar = jnet.encoder(jx)
    assert jmean.F.dtype == jlogvar.F.dtype == jnp.bfloat16
    eps = jnp.asarray(np.random.RandomState(7).randn(SHAPES, NARROW[-1]), jnp.bfloat16)
    jz = jmean.F + eps * jnp.exp(0.5 * jlogvar.F)
    jseed, _ = jm.insert_and_map(np.asarray(jmean.C), jnet.decoder_resolution_stride(jx))
    jcls, jtargets, jout = jnet.decoder(
        ME.SparseTensor(jz, coordinate_map_key=jseed, coordinate_manager=jm), jt)
    masks = [(np.asarray(c.F, np.float32)[:, 0] > 0) | np.asarray(t) for c, t in zip(jcls, jtargets)]
    z = torch.from_numpy(np.asarray(jz, np.float32))
    runs, enc = {}, {}
    for name, flag in (("bf16", True), ("f32", False)):
        bf16_policy(flag)
        tnet = VAE(channels=NARROW, in_nchannel=1, resolution=RES, device="cpu").train()
        load_state_dict_from_reference(tnet, sd)
        tnet.decoder.pruning = held = HeldPruning(tnet.decoder, masks)
        _, (_, tx, tt) = _inputs((full, feats, full))
        with torch.no_grad():
            mean, logvar = tnet.encoder(tx)
            enc[name] = {"mean": _f64(mean.F), "log_var": _f64(logvar.F)}
            tz = z.to(torch.bfloat16) if flag else z
            tcls, ttargets, tout = tnet.decoder(tnet.seed(tx, mean, tz), tt)
        held.check_levels()
        runs[name] = (held, tcls, ttargets, tout)
    bf16_policy(True)
    _bf16_judge(enc["bf16"], {"mean": _f64(jmean.F), "log_var": _f64(jlogvar.F)}, enc["f32"],
                "encoder")
    _held_flips({k: v[0] for k, v in runs.items()}, [c.F for c in jcls], "VAE decoder")
    for name, (_, tcls, ttargets, tout) in runs.items():
        for j, t, jtg, ttg in zip(jcls, tcls, jtargets, ttargets):
            assert t.coordinate_map_key.get_key() == j.coordinate_map_key.get_key()
            np.testing.assert_array_equal(t.C.numpy(), np.asarray(j.C))
            np.testing.assert_array_equal(ttg.numpy(), np.asarray(jtg))
        assert tout.tensor_stride == tuple(jout.tensor_stride) == (2, 2, 2)
        np.testing.assert_array_equal(tout.C.numpy(), np.asarray(jout.C))
    levels = range(len(jcls))
    _bf16_judge({i: _f64(runs["bf16"][1][i].F) for i in levels}, {i: _f64(jcls[i].F) for i in levels},
                {i: _f64(runs["f32"][1][i].F) for i in levels}, "decoder logits")


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
def test_vae_reparameterises_in_the_means_dtype(bf16_policy, vae_pair, batch, bf16):
    """The decoder input that ``VAE.forward`` builds: under bf16 JAX's
    expression (models/vae.py, ``mean + eps * exp(0.5 * log_var)``) with the
    noise in the mean's dtype and every op rounded to it, bit for bit, on
    the generator's draw; in float32 the float32 expression."""
    _, _, sd = vae_pair
    _, _, full = batch
    bf16_policy(bf16)
    tnet = VAE(channels=NARROW, in_nchannel=1, resolution=RES, device="cpu").train()
    load_state_dict_from_reference(tnet, sd)
    seen = {}
    tnet.decoder.register_forward_pre_hook(lambda m, a: seen.update(z=a[0].F))
    _, (_, tx, tt) = _inputs((full, np.ones((len(full), 1), np.float32), full))
    with torch.no_grad():
        _, _, _, mean, log_var = tnet(tx, tt, generator=torch.Generator().manual_seed(5))
    eps = torch.randn(mean.F.shape, generator=torch.Generator().manual_seed(5))
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert mean.F.dtype == log_var.F.dtype == seen["z"].dtype == dtype
    if bf16:
        def j(t):
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        want = j(mean.F) + j(eps) * jnp.exp(0.5 * j(log_var.F))
        assert want.dtype == jnp.bfloat16
        want = torch.from_numpy(np.asarray(want, np.float32))
    else:
        want = mean.F + eps * torch.exp(0.5 * log_var.F)
    assert torch.equal(seen["z"].float(), want)
    bf16_policy(False)
