"""Spawned gloo ranks for the port's multi-process CPU tests.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` spawned
processes, each with one thread, joined by a ``file://`` rendezvous under
``tmp_path`` (no port to clash across xdist workers), runs
``fn(rank, world, *args)`` in each and returns their results in rank order.
A rank that raises fails the call with its traceback, and the others are
killed.  This module imports only torch and the port, so the ranks never
load JAX; the rank functions the tests use live here too.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np


def _rank_entry(fn, rank: int, world: int, tmp: str, args: tuple) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=world)
        result = fn(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        out.write_bytes(pickle.dumps(("ok", result)))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise SystemExit(1)


class Ranks:
    """``world`` spawned ranks running ``fn``; ``wait()`` returns their
    results in rank order (the parent may work meanwhile)."""

    def __init__(self, fn, world: int, tmp_path, *args, timeout: float = 240.0):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.mkdtemp(dir=str(tmp_path), prefix="ranks_")
        self.procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, self.tmp, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def wait(self) -> list:
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if (any(p.exitcode not in (None, 0) for p in procs)
                        or time.monotonic() > self.deadline):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            f = Path(self.tmp) / f"rank{r}.pkl"
            if not f.exists():
                errors.append(f"rank {r}: no result (exit code {p.exitcode})")
                continue
            status, value = pickle.loads(f.read_bytes())
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            raise AssertionError("\n".join(errors))
        return results


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0) -> list:
    return Ranks(fn, world, tmp_path, *args, timeout=timeout).wait()


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def use_mesh(dp: int, tp: int):
    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh

    mesh = create_mesh(MeshConfig(dp=dp, tp=tp))
    set_current_mesh(mesh)
    return mesh


def _bind_fn(family: str):
    from licv_vqa_tpu_torch.models import idefics, idefics2, openflamingo

    return {
        "idefics": idefics.make_idefics_forward_fns,
        "idefics2": idefics2.make_idefics2_forward_fns,
        "openflamingo": openflamingo.make_openflamingo_forward_fns,
    }[family]


def tp_forward(rank: int, world: int, cases: dict) -> dict:
    """Each case on a (world/tp) x tp mesh: the numpy params sharded, the
    prefill logits, the greedy and (where ``beam``) the beam-3 tokens of
    the port's bind."""
    import torch

    from licv_vqa_tpu_torch.infer.decode import beam_generate, greedy_generate
    from licv_vqa_tpu_torch.models.weights import params_from_jax
    from licv_vqa_tpu_torch.parallel.sharding import shard_params

    out = {}
    for name, c in cases.items():
        mesh = use_mesh(world // c["tp"], c["tp"])
        params = shard_params(params_from_jax(c["params"]), mesh)
        bind = _bind_fn(c["family"])(c["cfg"], c["eos"])[1]
        ids, mask, pixels, valid = (torch.from_numpy(x) for x in c["inputs"])
        icv = None if c["icv"] is None else torch.from_numpy(c["icv"])
        max_new = c["max_new"]
        max_len = ids.shape[1] + max_new + 1
        with torch.no_grad():
            fwd = bind(params, pixels, valid, ids, icv, max_len)
            first = []

            def recording(*args, fwd=fwd, first=first):  # the first call: the prefill
                res = fwd(*args)
                if not first:
                    first.append(res[0].numpy())
                return res

            kw = dict(max_new_tokens=max_new, eos_token_id=c["eos"], pad_token_id=0)
            greedy = greedy_generate(recording, ids, mask, **kw)
            out[name] = {"logits": first[0], "greedy": greedy.numpy()}
            if c["beam"]:
                out[name]["beam"] = beam_generate(
                    bind(params, pixels, valid, ids, icv, max_len), ids, mask, num_beams=3,
                    length_penalty=0.0, **kw).numpy()
    return out


def tp_suite(rank: int, world: int, cases: dict, w8a8_args: tuple = ()) -> dict:
    """``tp_forward`` over ``cases``, then (given its inputs)
    ``w8a8_row_split``, in one spawn."""
    out = {"cases": tp_forward(rank, world, cases)}
    if w8a8_args:
        out["w8a8"] = w8a8_row_split(rank, world, *w8a8_args)
    return out


def w8a8_row_split(rank: int, world: int, x: np.ndarray, leaf: dict) -> dict:
    """``qdot_row`` under w8a8 on this rank's in-features of a row-split
    int8 leaf, and the same product quantized with the rank's LOCAL row
    absmax (what a missing all-reduce would give)."""
    import torch

    from licv_vqa_tpu_torch.ops.int8_matmul import quantize_act_rows, w8a8_prequantized_reference
    from licv_vqa_tpu_torch.parallel.sharding import qdot_row, reduce_from_tp, shard_params

    mesh = use_mesh(1, world)
    p = shard_params({"w_down": {k: torch.from_numpy(v) for k, v in leaf.items()}}, mesh)
    w = p["w_down"]
    k_local = w["q"].shape[0]
    xl = torch.from_numpy(x)[:, rank * k_local:(rank + 1) * k_local]
    got = qdot_row(xl, w, preferred_element_type=torch.float32, a8=True)
    xq, xs = quantize_act_rows(xl)  # the local absmax
    local = reduce_from_tp(w8a8_prequantized_reference(xq, xs, w["q"], w["s"], torch.float32))
    return {"got": got.numpy(), "local_absmax": local.numpy(), "k_local": k_local}


class ListLoader:
    """The threaded loader's surface the trainer reads: ``len`` and one
    pass over the same global batches each epoch."""

    def __init__(self, batches: list):
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _trainer(setup: dict, strategy: str, tp: int, **over):
    import torch

    import torch.distributed as dist

    from licv_vqa_tpu_torch.core.mesh import create_mesh
    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig
    from licv_vqa_tpu_torch.models import decoder, idefics
    from licv_vqa_tpu_torch.models.weights import params_from_jax
    from licv_vqa_tpu_torch.parallel.sharding import shard_params
    from licv_vqa_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = setup["cfg"]
    enc = GlobalICVEncoder(cfg.text.d_model, cfg.text.n_layers, **setup["enc_kw"])
    enc.load_params({k: np.array(v) for k, v in setup["enc_init"].items()})
    tcfg = TrainerConfig(strategy=strategy, tp=tp, **{**setup["trainer_kw"], **over})
    mesh = create_mesh(tcfg.mesh_config(dist.get_world_size()))  # as the train CLI does
    return Trainer(
        tcfg, ICVModuleConfig(**setup["module_kw"]), enc,
        idefics.make_idefics_forward_fns(cfg, setup["eos"])[0],
        shard_params(params_from_jax(setup["params"]), mesh), setup["pad"],
        metrics_hook=lambda step, m: setup["log"].append((step, m["loss"])),
        head_fn=lambda p, h: decoder.logits_from_hidden(cfg.text, p, h),
        mesh=mesh,
    )


def dp_train(rank: int, world: int, setup: dict, tmp: str) -> dict:
    """The port's ``Trainer`` over ``world`` ranks on the same global
    batches: ``dp`` (dp = world) and ``dp_tp`` (tp = world), the final
    ``(icv, alpha)`` and rank 0's logged losses; then a resume (the dp run
    again from its first step checkpoint) and a preemption flag raised on
    the last rank only before the second micro-step."""
    import shutil

    import torch.distributed as dist

    from licv_vqa_tpu_torch.core import distributed as D

    out = {}
    for strategy, tp in (("dp", 1), ("dp_tp", world)):
        setup["log"] = []
        run = Path(tmp) / strategy
        state = _trainer(setup, strategy, tp).fit(ListLoader(setup["batches"]), run)
        out[strategy] = {"icv": state.encoder.icv.detach().numpy().copy(),
                         "alpha": state.encoder.alpha.detach().numpy().copy(),
                         "losses": list(setup["log"]), "step": state.step,
                         "artifact": sorted(p.name for p in run.glob("*.pth"))}
        dist.barrier()

    # resume: drop the artifact and the last step checkpoint, fit again
    run = Path(tmp) / "dp"
    if rank == 0:
        (run / "icv_cpk.pth").unlink()
        (run / "steps" / f"step_{len(setup['batches'])}.pt").unlink()
        shutil.rmtree(Path(tmp) / "dp_tp")
    dist.barrier()
    setup["log"] = []
    state = _trainer(setup, "dp", 1).fit(ListLoader(setup["batches"]), run)
    out["resumed"] = {"icv": state.encoder.icv.detach().numpy().copy(),
                      "alpha": state.encoder.alpha.detach().numpy().copy(),
                      "losses": list(setup["log"])}
    dist.barrier()

    # preemption on the last rank only, before micro-step 2
    flag = rank == world - 1
    orig = D.PreemptionGuard.should_stop
    calls = []

    def should_stop(self):
        calls.append(1)
        return flag and len(calls) >= 2

    D.PreemptionGuard.should_stop = property(should_stop)
    try:
        setup["log"] = []
        run = Path(tmp) / "preempted"
        state = _trainer(setup, "dp", 1).fit(ListLoader(setup["batches"]), run)
    finally:
        D.PreemptionGuard.should_stop = orig
    dist.barrier()
    out["preempted"] = {"step": state.step,
                        "steps": sorted(p.name for p in (run / "steps").glob("step_*.pt")),
                        "artifact": sorted(p.name for p in run.glob("*.pth"))}
    return out


def use_sp_mesh(dp: int, tp: int, sp: int, cache: dict):
    """The ``(dp, tp, sp)`` mesh, created once a layout (``new_group`` is
    collective: every rank creates the same meshes in the same order)."""
    from licv_vqa_tpu_torch.core.mesh import MeshConfig, create_mesh, set_current_mesh

    key = (dp, tp, sp)
    if key not in cache:
        cache[key] = create_mesh(MeshConfig(dp=dp, tp=tp, sp=sp))
    set_current_mesh(cache[key])
    return cache[key]


def ring_cases(rank: int, world: int, cases: dict) -> dict:
    """Each case's ``ring_self_attention`` on this rank's rows, heads and
    chunk of the whole ``(q, k, v, positions, valid)``: the output, and
    where ``grad`` the gradients of ``Σ valid · out²`` (summed over the
    ranks by the ring's backward), with the rank's coordinates."""
    import torch

    from licv_vqa_tpu_torch.parallel.ring import ring_self_attention, sequence_ring

    meshes: dict = {}
    out = {}
    for name, c in cases.items():
        mesh = use_sp_mesh(*c["mesh"], meshes)
        dtype = getattr(torch, c["dtype"])
        b = c["q"].shape[0] // mesh.dp
        rows = slice(mesh.dp_index * b, (mesh.dp_index + 1) * b)
        pos = torch.from_numpy(c["pos"][rows])
        valid = torch.from_numpy(c["valid"][rows])
        ring = sequence_ring(pos, valid)

        def local(x, heads_per_rank):
            x = ring.take(torch.from_numpy(x[rows]))
            h0 = mesh.tp_index * heads_per_rank
            return x[:, :, h0:h0 + heads_per_rank].to(dtype).contiguous()

        h, kvh = c["q"].shape[2] // mesh.tp, c["k"].shape[2] // mesh.tp
        q, k, v = local(c["q"], h), local(c["k"], kvh), local(c["v"], kvh)
        if c["grad"]:
            for x in (q, k, v):
                x.requires_grad_(True)
        o = ring_self_attention(q, k, v, ring, n_heads=c["q"].shape[2], **c["kw"])
        res = {"out": o.detach().float().numpy(), "coords": (mesh.dp_index, mesh.tp_index,
                                                             mesh.sp_index)}
        if c["grad"]:
            w = ring.take(valid)[:, :, None, None].float()
            loss = torch.sum(w * o.float() ** 2)
            res["grads"] = [g.numpy() for g in torch.autograd.grad(loss, (q, k, v))]
        out[name] = res
    return out


def sp_train(rank: int, world: int, setup: dict, tmp: str) -> dict:
    """The port's ``Trainer`` over ``world`` ranks at ``dp_sp`` (sp = 2,
    dp = world/2) and ``dp_tp_sp`` (tp = 2, sp = 2): the final ``(icv,
    alpha, temperature)``, rank 0's logged losses and the artifacts; then a
    resume of the ``dp_sp`` run from its first step checkpoint."""
    import torch.distributed as dist

    out = {}

    def fit(strategy, tp, run):
        setup["log"] = []
        state = _trainer(setup, strategy, tp, sp=2).fit(ListLoader(setup["batches"]), run)
        return {"icv": state.encoder.icv.detach().numpy().copy(),
                "alpha": state.encoder.alpha.detach().numpy().copy(),
                "temperature": float(state.temperature.detach()), "losses": list(setup["log"]),
                "step": state.step, "artifact": sorted(p.name for p in run.glob("*.pth"))}

    for strategy, tp in (("dp_sp", 1), ("dp_tp_sp", 2)):
        out[strategy] = fit(strategy, tp, Path(tmp) / strategy)
        dist.barrier()
    run = Path(tmp) / "dp_sp"
    if rank == 0:
        (run / "icv_cpk.pth").unlink()
        (run / "steps" / f"step_{len(setup['batches'])}.pt").unlink()
    dist.barrier()
    out["resumed"] = fit("dp_sp", 1, run)
    return out


def sp_losses(rank: int, world: int, cases: dict) -> dict:
    """Each case's ``icv_loss_fn`` at dp 1 × sp ``world`` on its family's
    tiny model: the batch padded to an sp multiple by the trainer's
    ``_pad_seq_to_multiple``, the loss and the ``(icv, alpha,
    temperature)`` gradients reduced as the train step reduces them."""
    import dataclasses
    import functools

    import torch

    from licv_vqa_tpu_torch.icv.encoder import GlobalICVEncoder
    from licv_vqa_tpu_torch.icv.module import ICVModuleConfig, icv_loss_fn, reduce_gradients
    from licv_vqa_tpu_torch.models.weights import params_from_jax
    from licv_vqa_tpu_torch.train.trainer import _pad_seq_to_multiple, batch_to_device

    meshes: dict = {}
    out = {}
    for name, c in cases.items():
        use_sp_mesh(1, 1, world, meshes)
        cfg = c["cfg"]
        if c.get("remat_mode"):
            cfg = dataclasses.replace(cfg, remat_mode=c["remat_mode"])
        fwd = _bind_fn(c["family"])(cfg, c["eos"])[0]
        params = params_from_jax(c["params"], torch.float32)
        enc = GlobalICVEncoder(cfg.text.d_model, cfg.text.n_layers, **c["enc_kw"])
        enc.load_params({k: np.array(v) for k, v in c["enc"].items()})
        temp = torch.tensor(c["temperature"], requires_grad=True)
        batch = batch_to_device(_pad_seq_to_multiple(c["batch"], world, c["pad"]), "cpu")
        head = functools.partial(_head, cfg.text)
        loss, _ = icv_loss_fn(enc, temp, params, batch, fwd, ICVModuleConfig(**c["module_kw"]),
                              c["pad"], head)
        names = ("icv", "alpha", "temperature")
        grads = reduce_gradients(dict(zip(names, torch.autograd.grad(
            loss, (enc.icv, enc.alpha, temp)))))
        out[name] = {"loss": float(loss.detach()),
                     "lengths": [batch[k]["input_ids"].shape[1] for k in ("query_inputs", "inputs")],
                     **{k: grads[k].numpy() for k in names}}
    return out


def _head(text_cfg, params, hidden):
    from licv_vqa_tpu_torch.models import decoder

    return decoder.logits_from_hidden(text_cfg, params, hidden)
