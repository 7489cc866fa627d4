"""Port vs JAX: the mesh, the sharding rules and the explicit shards (CPU).

``MeshConfig.resolve``, the rank order and every process group's ranks at
dp × tp × sp against JAX's (its ``create_mesh`` device array); ``param_specs``
against JAX's ``param_specs`` leaf for leaf on the tiny trees of all three
families in bf16, int8 and int4 (a spec is a tuple of axis names in the
port, a ``PartitionSpec`` in JAX); every leaf the rules shard held as a
shard by ``shard_params``; int8 shards that concatenate back to the full
leaf; int4 row shards, re-packed per rank, that dequantize to the rank's
contiguous slice of JAX's dequantized weight.  No process group is needed:
the shards are pure functions of the tree and the rank.
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from licv_vqa_tpu.core.mesh import MeshConfig as JxMeshConfig
from licv_vqa_tpu.core.mesh import create_mesh as jx_create_mesh
from licv_vqa_tpu.ops.quantize import dequantize_int4 as jx_dequantize_int4
from licv_vqa_tpu.parallel.sharding import param_specs as jx_param_specs
from licv_vqa_tpu_torch.core.mesh import Mesh, MeshConfig, create_mesh, group_members, rank_coords
from licv_vqa_tpu_torch.models import registry as pt_registry
from licv_vqa_tpu_torch.models.weights import params_from_jax
from licv_vqa_tpu_torch.ops.quantize import is_any_quantized_leaf
from licv_vqa_tpu_torch.parallel.sharding import param_specs, shard_params
from tests import test_torch_idefics as T1
from tests import test_torch_idefics2 as T2
from tests import test_torch_openflamingo as T3


@pytest.mark.parametrize("cfg,n", [
    ((-1, 1, 1), 8), ((-1, 2, 1), 8), ((4, 2, 1), 8), ((2, -1, 1), 8), ((1, 2, -1), 8),
    ((-1, 3, 1), 8), ((-1, -1, 1), 8), ((2, 2, 1), 8), ((1, 1, 1), 1),
    ((-1, 2, 2), 8), ((2, -1, 2), 8), ((1, 1, -1), 8), ((-1, 1, 3), 8), ((2, 2, 2), 8),
])
def test_mesh_config_resolve_matches_jax(cfg, n):
    try:
        want = JxMeshConfig(*cfg).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            MeshConfig(*cfg).resolve(n)
        return
    assert MeshConfig(*cfg).resolve(n) == want


MESH_SHAPES = [(4, 2, 1), (2, 2, 2), (1, 2, 4), (2, 1, 4), (8, 1, 1), (1, 1, 8)]


def _jax_ranks(dp: int, tp: int, sp: int) -> np.ndarray:
    """JAX's ``create_mesh`` device array over 8 virtual devices, as ranks."""
    mesh = jx_create_mesh(JxMeshConfig(dp=dp, tp=tp, sp=sp), jax.devices()[:8])
    return np.vectorize(lambda d: d.id - jax.devices()[0].id)(mesh.devices)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_rank_order_is_jax_device_order(shape):
    """JAX reshapes the device list to (dp, tp, sp): device ``i`` sits at
    the mesh coordinates the port gives rank ``i`` (sp fastest, then tp)."""
    ranks = _jax_ranks(*shape)
    for idx in np.ndindex(*shape):
        assert rank_coords(int(ranks[idx]), *shape) == idx


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_groups_are_jax_mesh_slices(shape):
    """Each process group is a slice of JAX's device array: tp the ranks
    of one (dp, sp) index, dp of one (tp, sp), sp of one (dp, tp), and the
    gradient group the dp × sp ranks of one tp index."""
    ranks = _jax_ranks(*shape)
    dp, tp, sp = shape
    groups = group_members(*shape)
    want = {
        "tp": [ranks[d, :, s] for d in range(dp) for s in range(sp)],
        "dp": [ranks[:, t, s] for t in range(tp) for s in range(sp)],
    }
    if sp > 1:
        want["sp"] = [ranks[d, t, :] for d in range(dp) for t in range(tp)]
        want["grad"] = [ranks[:, t, :].reshape(-1) for t in range(tp)]
    assert set(groups) == set(want)
    for name, lists in want.items():
        assert groups[name] == [list(map(int, x)) for x in lists], name


def test_one_process_mesh_and_sp_raise():
    """One process: a mesh of one rank has no groups; a mesh of more ranks,
    sp included, raises without a default group."""
    mesh = create_mesh(MeshConfig(dp=-1, tp=1))
    assert (mesh.dp, mesh.tp, mesh.sp, mesh.tp_group, mesh.dp_group, mesh.sp_group) == (
        1, 1, 1, None, None, None)
    for cfg in (MeshConfig(dp=1, tp=2), MeshConfig(dp=1, tp=1, sp=2)):
        with pytest.raises(RuntimeError, match="initialised"):
            create_mesh(cfg, world_size=2, rank=0)


@pytest.mark.parametrize("over", [{}, {"strategy": "dp_tp", "tp": 2}, {"devices": 2}])
def test_a_trainer_given_no_mesh_is_one_process(over):
    """Without a mesh the trainer runs one process: a config that asks for
    more ranks raises, and its mesh is current only inside ``using_mesh``."""
    from licv_vqa_tpu_torch.core.mesh import current_mesh, using_mesh
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig
    from licv_vqa_tpu_torch.train.trainer import Trainer, TrainerConfig

    def make():
        return Trainer(TrainerConfig(**over), ICVModuleConfig(),
                       SimpleNamespace(icv=torch.zeros(1)), None, {}, 0)

    if over:
        with pytest.raises(ValueError):
            make()
        return
    trainer = make()
    assert (trainer.mesh.dp, trainer.mesh.tp, trainer.mesh.tp_group) == (1, 1, None)
    assert current_mesh() is None
    with using_mesh(trainer.mesh):
        assert current_mesh() is trainer.mesh
    assert current_mesh() is None


def _trees():
    """{family: numpy tree} of the three tiny families (JAX's init)."""
    return {
        "idefics": jax.tree.map(np.asarray, T1.tiny_pair()[1]),
        "idefics2": jax.tree.map(np.asarray, T2.tiny_pair()[1]),
        "openflamingo": jax.tree.map(np.asarray, T3.tiny_pair()[1]),
    }


def _quantized(tree: dict, mode: str) -> dict:
    """The registry's quantization with every option (head int8, tower,
    perceiver and connector int8), as numpy, in JAX's leaf dtypes."""
    if mode == "bf16":
        return jax.tree.map(lambda x: np.asarray(x).astype(jnp.bfloat16), tree)
    lmm = {"quantize": mode, "quantize_head": True, "quantize_vision": True}
    ns = SimpleNamespace(lmm=SimpleNamespace(get=lambda k, d=None: lmm.get(k, d)))
    cfg = SimpleNamespace(text=SimpleNamespace(tie_embeddings="lm_head" not in tree))
    q = pt_registry._maybe_quantize(ns, SimpleNamespace(params=params_from_jax(tree),
                                                        model_cfg=cfg)).params
    return jax.tree.map(lambda t: t.float().numpy().astype(jnp.bfloat16)
                        if t.dtype == torch.bfloat16 else t.numpy(), q)


@pytest.fixture(scope="module")
def trees():
    base = _trees()
    return {(fam, mode): _quantized(tree, mode) for fam, tree in base.items()
            for mode in ("bf16", "int8", "int4")}


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and not is_any_quantized_leaf(tree):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield f"{prefix}{k}", v
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("family", ["idefics", "idefics2", "openflamingo"])
def test_param_specs_equal_jax_leaf_for_leaf(trees, family, mode):
    tree = trees[(family, mode)]
    want = jax.tree.map(tuple, jx_param_specs(tree), is_leaf=lambda x: isinstance(x, P))
    got = param_specs(params_from_jax(tree))
    assert got == want
    sharded = [k for k, s in _flat(got) if "tp" in s]
    assert any(".w_down" in k for k in sharded)
    assert any("lm_head" in k for k in sharded) == ("lm_head" in tree)  # MPT ties its head


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("family", ["idefics", "idefics2", "openflamingo"])
def test_every_leaf_the_rules_shard_is_held_as_a_shard(trees, family, mode):
    """The shard of each tp-split leaf is 1/tp of it along the split dim
    (the head: of its vocab padded to a tp multiple); the rest stay whole."""
    tree = trees[(family, mode)]
    specs = dict(_flat(param_specs(params_from_jax(tree))))
    full = dict(_flat(params_from_jax(tree)))
    shard = dict(_flat(shard_params(params_from_jax(tree), Mesh(1, 2, 1, 0, 1))))
    assert shard.keys() == full.keys()
    for key, spec in specs.items():
        f, s = full[key], shard[key]
        if "tp" not in spec:
            assert s.shape == f.shape, key
            continue
        dim = spec.index("tp")
        if key.endswith(".s") and f.shape[dim] == 1:
            # an int4 row leaf of one group (tiny widths): each rank's
            # re-packed half keeps that group's scales
            assert s.shape == f.shape, key
            continue
        n = f.shape[dim] + (f.shape[dim] % 2 if key.startswith("lm_head") else 0)
        assert s.shape[dim] * 2 == n and s.numel() * 2 == f.numel() + (
            f.numel() // f.shape[dim] * (n - f.shape[dim])), key


@pytest.mark.parametrize("tp", [2, 4])
def test_int8_shards_concatenate_back_to_the_full_leaf(trees, tp):
    tree = trees[("idefics", "int8")]
    full = dict(_flat(params_from_jax(tree)))
    specs = dict(_flat(param_specs(params_from_jax(tree))))
    shards = [dict(_flat(shard_params(params_from_jax(tree), Mesh(1, tp, r, 0, r))))
              for r in range(tp)]
    checked = 0
    for key, spec in specs.items():
        if "tp" not in spec:
            continue
        dim = spec.index("tp")
        whole = torch.cat([s[key] for s in shards], dim=dim)
        torch.testing.assert_close(whole.narrow(dim, 0, full[key].shape[dim]), full[key],
                                   rtol=0, atol=0)
        checked += 1
    assert checked > 20


@pytest.mark.parametrize("family", ["idefics", "idefics2", "openflamingo"])
def test_int4_row_shards_dequantize_to_the_ranks_slice_of_jax(trees, family):
    """A row-split int4 leaf re-packed per rank dequantizes to the rank's
    contiguous in-features of JAX's dequantized weight, bit for bit."""
    from licv_vqa_tpu_torch.ops.quantize import dequantize_int4

    tree = trees[(family, "int4")]
    rows = {k: v for k, v in _flat(tree) if k.endswith((".q4", ".s")) and
            k.rsplit(".", 2)[-2] in ("wo", "w_down")}
    leaves = {k.rsplit(".", 1)[0] for k in rows if k.endswith(".q4")}
    assert leaves
    for leaf in leaves:
        jleaf = {"q4": jnp.asarray(rows[leaf + ".q4"]), "s": jnp.asarray(rows[leaf + ".s"])}
        want = np.asarray(jx_dequantize_int4(jleaf, jnp.float32))
        k = want.shape[-2]
        for r in range(2):
            path = leaf.split(".")
            sub = params_from_jax(tree)
            for p in path[:-1]:
                sub = sub[p]
            got = shard_params({path[-1]: sub[path[-1]]}, Mesh(1, 2, r, 0, r))[path[-1]]
            np.testing.assert_array_equal(
                dequantize_int4(got, torch.float32).numpy(),
                want[..., r * k // 2:(r + 1) * k // 2, :])
