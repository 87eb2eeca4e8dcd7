"""The bf16 training slice against the JAX package under ``set_compute_dtype(bf16)``.

A narrow MinkUNet34 takes two SGD steps and a narrow MinkowskiFCNN one, in
both packages under the bf16 policy (``optax.sgd`` and ``torch.optim.SGD``,
logits cast to float32 before the cross-entropy), from the same weights on
the same batches.  The port is judged against the float32 run of the same
step, with JAX's bf16 run as the yardstick of what bf16 costs:

* at random weights in train mode the gradients are badly conditioned
  (batch norm over the few rows of the deep levels subtracts batch means),
  so bf16 rounding moves them far: JAX's own bf16 gradients lie a median
  ~0.6 (step 0) to ~1.2 (step 1) of max |g| per tensor from the float32
  ones, and the two packages round in different places (JAX's CPU convs
  round their sum after every offset, the port's once; see
  test_torch_sparse_conv_bf16.py), so they cannot agree more closely;
* each port tensor's distance from the float32 run, max |Δ| / max |ref|,
  must stay within FACTOR = 4 times JAX's bf16 distance for that tensor,
  or JAX's median distance where that tensor happens to round better
  (measured: at most 1.9 times), and the port's median distance within 1.5
  times JAX's (measured 0.4-1.0 times): the port's bf16 step is no worse
  than JAX's;
* the loss within 4 times JAX's bf16 distance from the float32 loss, or
  1e-3 of it (measured: 1.5e-4 to 3.7e-3 from the float32 loss, JAX 8e-4
  to 4.3e-3).

The single layers are held tightly elsewhere (test_torch_compute_dtype.py,
test_torch_sparse_conv_bf16.py).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import minkowskiengine_tpu as ME
from minkowskiengine_tpu.models.classification import MinkowskiFCNN as JFCNN
from minkowskiengine_tpu.utils.torch_import import export_reference_state_dict
import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.models import MinkowskiFCNN
from minkowskiengine_tpu_torch.utils.datasets import modelnet_batch
from minkowskiengine_tpu_torch.utils.torch_import import load_state_dict_from_reference
from test_torch_classification import NARROW_FCNN, NCLS, _jax_field, _jax_modes, _torch_field
from test_torch_train import JNarrow, TNarrow, _batch, _rel

FACTOR = 4.0
MEDIAN_FACTOR = 1.5
LR = 0.1
STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture
def both_bf16():
    """Sets the policy in both packages; resets both to None after."""
    def on(flag):
        ME.set_compute_dtype(jnp.bfloat16 if flag else None)
        MT.set_compute_dtype(torch.bfloat16 if flag else None)
    yield on
    on(False)


def _judge(port, jaxb, ref, what):
    """Per name: port vs the float32 ``ref`` within FACTOR of JAX's bf16
    distance (floored at JAX's median); medians within MEDIAN_FACTOR."""
    d_port = {k: _rel(port[k], ref[k]) for k in ref}
    d_jax = {k: _rel(jaxb[k], ref[k]) for k in ref}
    med_jax = float(np.median(list(d_jax.values())))
    worst = max(d_port, key=lambda k: d_port[k] / max(d_jax[k], med_jax))
    ratio = d_port[worst] / max(d_jax[worst], med_jax)
    assert ratio <= FACTOR, (what, worst, d_port[worst], d_jax[worst], med_jax)
    med_port = float(np.median(list(d_port.values())))
    assert med_port <= MEDIAN_FACTOR * med_jax, (what, med_port, med_jax)


def _judge_loss(port, jaxb, ref, what):
    assert abs(port - ref) <= max(FACTOR * abs(jaxb - ref), 1e-3 * abs(ref)), (what, port, jaxb, ref)


def _np(t, like):
    return t.detach().float().numpy().reshape(np.shape(like))


def test_minkunet34_two_sgd_steps(both_bf16):
    jnet = JNarrow(3, 5, D=3, rngs=nnx.Rngs(1))
    init = export_reference_state_dict(jnet)
    batches = [_batch((0, 1)), _batch((2, 3))]

    # JAX under bf16
    both_bf16(True)
    jnet.train()
    jopt = nnx.Optimizer(jnet, optax.sgd(LR), wrt=nnx.Param)
    jax_steps = []
    for coords, feats, labels in batches:
        def loss_fn(m):
            logits = m(ME.SparseTensor(jnp.asarray(feats), jnp.asarray(coords))).F
            assert logits.dtype == jnp.bfloat16
            return optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), jnp.asarray(labels)).mean()

        loss, grads = nnx.value_and_grad(loss_fn)(jnet)
        named = nnx.clone(jnet)
        nnx.update(named, grads)
        jopt.update(jnet, grads)
        sd = export_reference_state_dict(named)
        jax_steps.append((float(loss), {k: v for k, v in sd.items() if not k.endswith(STATS)}))
    jax_state = export_reference_state_dict(jnet)

    # the port in bf16, then in float32 as the yardstick
    def port_run(bf16):
        both_bf16(bf16)
        tnet = TNarrow(3, 5, D=3, device="cpu").train()
        load_state_dict_from_reference(tnet, init)
        opt = torch.optim.SGD(tnet.parameters(), lr=LR)
        steps = []
        for coords, feats, labels in batches:
            out = tnet(MT.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords)))
            assert out.F.dtype is (torch.bfloat16 if bf16 else torch.float32)
            loss = torch.nn.functional.cross_entropy(out.F.float(), torch.from_numpy(labels).long())
            opt.zero_grad()
            loss.backward()
            assert all(p.grad.dtype is torch.float32 for p in tnet.parameters())
            steps.append((loss.item(), {k: p.grad.clone() for k, p in tnet.named_parameters()}))
            opt.step()
        return steps, {k: v for k, v in tnet.state_dict().items() if not k.endswith("tracked")}

    port, port_state = port_run(True)
    ref, ref_state = port_run(False)
    for s in range(2):
        names = jax_steps[s][1]
        _judge_loss(port[s][0], jax_steps[s][0], ref[s][0], f"loss {s}")
        _judge({k: _np(port[s][1][k], names[k]) for k in names}, names,
               {k: _np(ref[s][1][k], names[k]) for k in names}, f"gradients {s}")
    _judge({k: _np(v, jax_state[k]) for k, v in port_state.items()}, jax_state,
           {k: _np(v, jax_state[k]) for k, v in ref_state.items()}, "weights and statistics")


def test_fcnn_one_sgd_step(both_bf16):
    """Global max and average pooling, the linears and batch norm on bf16
    features; dropout off in both packages."""
    batch = modelnet_batch(4, n_points=256, seed=0, voxel_size=0.05)
    labels = batch[2]
    jnet = JFCNN(3, NCLS, rngs=nnx.Rngs(0), **NARROW_FCNN)
    init = export_reference_state_dict(jnet)

    both_bf16(True)
    _jax_modes(jnet, True, False)

    def loss_fn(m):
        logits = m(_jax_field(batch))
        assert logits.dtype == jnp.bfloat16
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    jloss, grads = nnx.value_and_grad(loss_fn)(jnet)
    named = nnx.clone(jnet)
    nnx.update(named, grads)
    jgrads = {k: v for k, v in export_reference_state_dict(named).items() if not k.endswith(STATS)}

    def port_run(bf16):
        both_bf16(bf16)
        tnet = MinkowskiFCNN(3, NCLS, device="cpu", **NARROW_FCNN).train()
        tnet.final[1].eval()  # dropout off
        load_state_dict_from_reference(tnet, init)
        logits = tnet(_torch_field(batch))
        assert logits.dtype is (torch.bfloat16 if bf16 else torch.float32)
        loss = torch.nn.functional.cross_entropy(logits.float(), torch.from_numpy(labels).long())
        loss.backward()
        opt = torch.optim.SGD(tnet.parameters(), lr=LR)
        opt.step()
        return loss.item(), {k: p.grad.clone() for k, p in tnet.named_parameters()}

    (ploss, pgrads), (rloss, rgrads) = port_run(True), port_run(False)
    assert set(pgrads) == set(jgrads)
    assert all(g.dtype is torch.float32 for g in pgrads.values())
    _judge_loss(ploss, float(jloss), rloss, "loss")
    _judge({k: _np(pgrads[k], v) for k, v in jgrads.items()}, jgrads,
           {k: _np(rgrads[k], v) for k, v in jgrads.items()}, "gradients")
