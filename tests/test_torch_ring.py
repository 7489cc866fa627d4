"""Port vs JAX: ring attention over the sp axis (CPU, spawned gloo ranks).

The port's ``ring_self_attention`` runs in spawned ranks
(``tests/torch_dist_common.py``) on each rank's rows, heads and chunk of
the same numpy ``(q, k, v)`` and is held to JAX's dense
``layers.dot_product_attention`` under the causal-and-padding mask from
absolute positions, with JAX's own tolerances (``tests/test_ring.py``):
5e-6 on valid rows for causal with padding, ALiBi and the tanh softcap in
f32; 2e-2 for bf16 operands; 2e-5 for dq, dk and dv against ``jax.grad``
of the dense path.  Meshes: sp = 2, sp = 4, tp 2 × sp 2 (the heads split,
the ALiBi slopes sliced to the rank's) and dp 2 × sp 2.  The rows mix a
full row, right padding whose real tokens end inside a later chunk, left
padding and a row whose last real token sits in the second chunk; one
case has two KV heads under four query heads (the ring moves the KV heads
and repeats them per block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from licv_vqa_tpu.models import layers as L
from tests.torch_dist_common import Ranks, ring_cases

B, S, H, DH = 4, 64, 4, 32
F32_TOL, BF16_TOL, GRAD_TOL = 5e-6, 2e-2, 2e-5


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, S, H, DH)).astype(np.float32) for _ in range(3))
    idx = np.arange(S)[None, :]
    valid = np.stack([idx[0] < S, idx[0] < S - 13, idx[0] >= 20, idx[0] < 40])
    pos = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    return q, k, v, pos, valid


def _dense(q, k, v, pos, valid, kw):
    pj, vj = jnp.asarray(pos), jnp.asarray(valid)
    mask = L.causal_mask(pj, pj, vj)
    bias = L.alibi_bias(q.shape[2], pj, pj) if kw.get("alibi") else None
    n_rep = q.shape[2] // k.shape[2]
    return L.dot_product_attention(
        q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep), bias=bias, mask=mask,
        logit_softcap=kw.get("logit_softcap"))


KINDS = {
    "causal_pad": {}, "alibi": {"alibi": True}, "softcap": {"logit_softcap": 30.0},
}
MESHES = {2: [(1, 1, 2)], 4: [(1, 1, 4), (1, 2, 2), (2, 1, 2)]}


def _cases():
    q, k, v, pos, valid = _inputs()
    base = {"pos": pos, "valid": valid}
    by_world = {}
    for world, meshes in MESHES.items():
        cases = {}
        for mesh in meshes:
            tag = "x".join(map(str, mesh))
            for kind, kw in KINDS.items():
                cases[f"{tag}-{kind}"] = dict(base, mesh=mesh, dtype="float32", kw=kw, q=q, k=k,
                                              v=v, grad=False)
            cases[f"{tag}-bf16"] = dict(base, mesh=mesh, dtype="bfloat16", kw={}, q=q, k=k,
                                        v=v, grad=False)
            cases[f"{tag}-grad"] = dict(base, mesh=mesh, dtype="float32", kw={}, q=q, k=k,
                                        v=v, grad=True)
        cases[f"{'x'.join(map(str, meshes[0]))}-gqa"] = dict(
            base, mesh=meshes[0], dtype="float32", kw={"alibi": True}, q=q, k=k[:, :, :2],
            v=v[:, :, :2], grad=True)
        by_world[world] = cases
    return by_world


def _assemble(ranks: list, name: str, key, shape) -> np.ndarray:
    """The ranks' (rows, chunk, heads) blocks of one case put back whole."""
    out = np.zeros(shape, np.float32)
    for r in ranks:
        d, t, s = r[name]["coords"]
        x = r[name][key] if isinstance(key, str) else r[name]["grads"][key]
        b, c, h = x.shape[:3]
        out[d * b:(d + 1) * b, s * c:(s + 1) * c, t * h:(t + 1) * h] = x
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    by_world = _cases()
    pending = {w: Ranks(ring_cases, w, tmp, cases) for w, cases in by_world.items()}
    return by_world, {w: p.wait() for w, p in pending.items()}


def _all_cases():
    return [(w, name) for w, cases in _cases().items() for name in cases]


@pytest.mark.parametrize("world,name", _all_cases())
def test_ring_matches_jax_dense_attention(runs, world, name):
    by_world, results = runs
    c, ranks = by_world[world][name], results[world]
    kw, valid = c["kw"], c["valid"]
    q, k, v = (jnp.asarray(c[x]) for x in ("q", "k", "v"))
    if c["dtype"] == "bfloat16":
        q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_dense(q, k, v, c["pos"], valid, kw)).astype(np.float32)
    got = _assemble(ranks, name, "out", q.shape)
    err = np.abs(got - want)[valid].max()
    assert err < (BF16_TOL if c["dtype"] == "bfloat16" else F32_TOL), err
    if not c["grad"]:
        return
    w = jnp.asarray(valid)[:, :, None, None]

    def f(q, k, v):
        return jnp.sum(jnp.where(w, _dense(q, k, v, c["pos"], valid, kw) ** 2, 0.0))

    for i, g in enumerate(jax.grad(f, argnums=(0, 1, 2))(q, k, v)):
        got_g = _assemble(ranks, name, i, g.shape)
        assert np.abs(got_g - np.asarray(g)).max() < GRAD_TOL, (i, np.abs(got_g - g).max())


def test_a_sequence_sp_does_not_divide_raises():
    """No fallback to the whole sequence on each rank: S % sp != 0 raises
    (the trainer pads first), as does an sp mesh without its group."""
    import torch

    from licv_vqa_tpu_torch.core.mesh import Mesh, using_mesh
    from licv_vqa_tpu_torch.parallel.ring import sequence_ring

    pos = torch.zeros((2, 6), dtype=torch.int32)
    mesh = Mesh(dp=1, tp=1, rank=0, dp_index=0, tp_index=0, sp=4, sp_index=0, sp_group=object())
    with using_mesh(mesh), pytest.raises(ValueError, match="S % sp == 0"):
        sequence_ring(pos, pos)
    with using_mesh(Mesh(dp=1, tp=1, rank=0, dp_index=0, tp_index=0, sp=2)):
        with pytest.raises(RuntimeError, match="without an sp process group"):
            sequence_ring(pos, pos)
    assert sequence_ring(pos, pos) is None  # no mesh: one process
