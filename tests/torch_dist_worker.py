"""One rank of the multi-device parity tests (started by ``tests/torch_dist.py``).

    python tests/torch_dist_worker.py JOB RANK WORLD PORT

Joins a gloo group of WORLD ranks (one node, one thread each) on localhost:PORT, runs the job's cases
in order (every rank runs every case: they hold collectives) and writes its
results to JOB.rank<RANK>. Imports the port, torch and numpy only.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
from recommendations_tpu_torch.parallel import collectives as col

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _rows(x: np.ndarray, mesh, axis: str = "data") -> np.ndarray:
    """This rank's block of rows along ``axis``."""
    n = x.shape[0] // mesh.size(axis)
    return x[mesh.index(axis) * n:(mesh.index(axis) + 1) * n]


def _mesh(data: int, model: int = 1, expert: int = 1, device="cpu"):
    return build_mesh(MeshConfig(data=data, model=model, expert=expert), device=device)


# -- the row-sharded table --------------------------------------------------------


@case
def lookup(model, schedule, table, ids, num_shifts=None, target=None, capacity_factor=2.0, normalize=False,
           device="cpu"):
    """A sharded lookup (KShift, or plain with ``num_shifts`` None) of this
    rank's data rows; with ``target``, the table shard's gradient of
    sum((out - target)^2)."""
    from recommendations_tpu_torch.parallel import sharded_embedding as se

    mesh = _mesh(dist.get_world_size() // model, model, device=device)
    group, data_group = mesh.group("model"), mesh.group("data")
    shard = torch.tensor(_rows(table, mesh, "model"), device=device, requires_grad=True)
    ids_local = torch.from_numpy(_rows(ids, mesh)).to(device)
    n_emb = table.shape[0]
    overflow = None
    if num_shifts is None:
        if schedule == "psum":
            out = se.sharded_embedding_lookup(shard, ids_local, group, n_emb)
        else:
            out, overflow = se.alltoall_embedding_lookup(shard, ids_local, group, n_emb,
                                                         capacity_factor=capacity_factor, data_group=data_group)
    elif schedule == "psum":
        out = se.sharded_kshift_lookup(shard, ids_local, group, n_emb, num_shifts, normalize)
    else:
        out, overflow = se.alltoall_kshift_lookup(shard, ids_local, group, n_emb, num_shifts, normalize,
                                                  capacity_factor=capacity_factor, data_group=data_group)
    if target is not None:
        ((out - torch.from_numpy(_rows(target, mesh)).to(device)) ** 2).sum().backward()
    return {"out": _np(out), "grad": _np(shard.grad), "coords": mesh.coords, "device": str(out.device),
            "overflow": None if overflow is None else float(overflow)}


# -- ring attention and the sequence-parallel stack ---------------------------------


@case
def ring(model, causal, q, k, v, co, tab=None, nk=0, device="cpu"):
    """Ring attention of this rank's data rows over the ring of ``model``
    ranks, and the gradients of sum(out * co)."""
    from recommendations_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_padded

    mesh = _mesh(dist.get_world_size() // model, model, device=device)
    group = mesh.group("model")
    qt, kt, vt = (torch.tensor(_rows(x, mesh), device=device, requires_grad=True) for x in (q, k, v))
    tt = None if tab is None else torch.tensor(tab, device=device, requires_grad=True)
    if causal:
        out = ring_attention_padded(qt, kt, vt, group, causal=True, bias_table=tt, nk=nk)
    else:
        blocks = [col.scatter_to_group(x, group, dim=2) for x in (qt, kt, vt)]
        table = None if tt is None else col.copy_to_group(tt, group)
        out = col.all_gather(ring_attention(*blocks, group, causal=False, bias_table=table, nk=nk), group, dim=2)
    (out * torch.from_numpy(_rows(co, mesh)).to(device)).sum().backward()
    return {"out": _np(out), "device": str(out.device), "dq": _np(qt.grad), "dk": _np(kt.grad), "dv": _np(vt.grad),
            "dtab": None if tt is None else _np(tt.grad), "coords": mesh.coords}


@case
def seq_stack(state, x, cot, attn_type, window=None, model=2):
    """The sequence-parallel stack (2 layers, d=16, 2 heads) on this rank's
    data rows: output, the input's gradient and every parameter's gradient
    of sum(out * cot) (this rank's part)."""
    from recommendations_tpu_torch.nn.transformer import TransformerStack

    mesh = _mesh(dist.get_world_size() // model, model)
    stack = TransformerStack(2, 16, 2, torch.Generator().manual_seed(0), attn_type=attn_type, is_causal=True,
                             pos_bias_window=window)
    stack.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    stack.bind_sequence_parallel(mesh.group("model"))
    xt = torch.tensor(_rows(x, mesh), requires_grad=True)
    out = stack(xt)
    (out * torch.from_numpy(_rows(cot, mesh))).sum().backward()
    return {"out": _np(out), "dx": _np(xt.grad), "coords": mesh.coords,
            "grads": {k: _np(p.grad) for k, p in stack.named_parameters()}}


@case
def collectives(device="cpu"):
    """Each collective on this rank's tensors over the world: the values,
    the output device, and the gradients of the differentiable ones."""
    group, r, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    x = torch.arange(2 * n, dtype=torch.float32, device=device) + 10 * r
    out = {"all_gather": col.all_gather_tensor(x, group), "all_to_all": col.all_to_all_tensor(x, group),
           "ppermute": col.ppermute_tensor(x, group), "ppermute_back": col.ppermute_tensor(x, group, -1)}
    y = x.clone().requires_grad_()
    w = torch.arange(1, 2 * n + 1, dtype=torch.float32, device=device)
    (col.psum(y, group) * w).sum().backward()
    out["psum_grad"] = y.grad.clone()
    y.grad = None
    (col.copy_to_group(y, group) * w * (r + 1)).sum().backward()
    out["copy_grad"] = y.grad.clone()
    y.grad = None
    (col.all_gather(y, group) * torch.arange(2 * n * n, dtype=torch.float32, device=device)).sum().backward()
    out["all_gather_grad"] = y.grad.clone()
    y.grad = None
    (col.ppermute(y, group) * w * (r + 1)).sum().backward()
    out["ppermute_grad"] = y.grad.clone()
    res = {k: _np(v) for k, v in out.items()}
    res["devices"] = sorted({str(v.device) for v in out.values()})
    return res


# -- expert parallelism ---------------------------------------------------------------


@case
def moe(state, x, cot, out_features, proj_features, num_experts, top_k=None, gate_sizes=()):
    """``MoELinear`` over an expert group of every rank: output and the
    gradients of sum(out * cot)."""
    from recommendations_tpu_torch.nn.transformer import MoELinear

    mesh = _mesh(1, 1, dist.get_world_size())
    m = MoELinear(x.shape[-1], out_features, proj_features, num_experts, torch.Generator().manual_seed(0),
                  top_k=top_k, gate_sizes=tuple(gate_sizes))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    m.bind_experts(mesh.group("expert"))
    xt = torch.tensor(x, requires_grad=True)
    out = m(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return {"out": _np(out), "dx": _np(xt.grad), "grads": {k: _np(p.grad) for k, p in m.named_parameters()},
            "coords": mesh.coords}


@case
def moe_lthm(config, batch, offsets):
    """The MoE LTHM's validation loss with its experts over every rank
    (the wrapper's seeded weights, as one process's)."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

    mesh = _mesh(1, 1, dist.get_world_size())
    w = LTHMModelWrapper(LTHMModelConfig.from_dict(config), device="cpu")
    w.bind_mesh(mesh)
    shapes = {k: tuple(p.shape) for k, p in w.module.named_parameters() if "moe_" in k}
    loss, metrics, _ = w.loss_and_metrics(batch, w.init_aux_state(), False, offsets=offsets)
    return {"loss": float(loss), "val_loss": float(metrics["val_loss"]), "shapes": shapes}


# -- data-parallel training -------------------------------------------------------------


@case
def train(args, variables=None, offsets=None, env=None, copy_checkpoints=None):
    """``main_training`` on this rank, from JAX's initial ``variables``
    (of an LTHM or a ranker) with JAX's lookahead ``offsets`` step by step:
    its final metrics and parameters (one device's, after the run)."""
    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.models.lthm import loss as port_loss
    from recommendations_tpu_torch.models.lthm.builder import LTHMModelBuilder
    from recommendations_tpu_torch.models.ranker.builder import RankerModelBuilder

    old_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    if copy_checkpoints:
        src, dst = copy_checkpoints
        if dist.get_rank() == 0:
            shutil.copytree(src, dst)
        dist.barrier()
    from recommendations_tpu_torch.train.optimizers import TrainOptimizer

    pending = [np.asarray(o) for o in (offsets or [])]
    original_offsets = port_loss.sample_offsets
    builders = {cls: cls.build for cls in (LTHMModelBuilder, RankerModelBuilder)}
    original_step = TrainOptimizer.step
    first = []  # the first step's gradients, summed over the mesh, before the optimizer

    def step(self):
        if not first:
            first.append([None if p.grad is None else _np(p.grad) for p in self.clip_params])
        return original_step(self)

    def jax_offsets(generator, lookahead):
        # draw anyway: the generator then moves as in an unpatched run
        drawn = original_offsets(generator, lookahead)
        return torch.from_numpy(pending.pop(0).copy()) if pending else drawn

    def loading(original_build):
        def build(self):
            wrapper = original_build(self)
            if variables is not None:
                wrapper.load_jax_variables(variables)
            return wrapper
        return build

    port_loss.sample_offsets, TrainOptimizer.step = jax_offsets, step
    for cls, original_build in builders.items():
        cls.build = loading(original_build)
    try:
        pipeline, metrics = main_training.main(["--device", "cpu", *args], return_pipeline=True)
    finally:
        port_loss.sample_offsets, TrainOptimizer.step = original_offsets, original_step
        for cls, original_build in builders.items():
            cls.build = original_build
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wrapper = pipeline._trained[0]
    names = [k for k, _ in wrapper.module.named_parameters()]
    return {"metrics": {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
            "params": {k: _np(v) for k, v in wrapper.module.state_dict().items()},
            "first_grads": dict(zip(names, first[0])) if first else {}}


@case
def ranker_steps(config, variables, batches):
    """The ranker's ``train_step`` on this rank's rows of each global batch
    (``data`` over every rank), from JAX's ``variables``: each step's loss
    and metrics, the validation metrics of the last batch after the steps,
    and the parameters."""
    from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
    from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
    from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    mesh = _mesh(dist.get_world_size())
    w = RankerModelWrapper(RankerModelConfig.from_dict(config), device="cpu")
    w.load_jax_variables(variables)
    w.bind_mesh(mesh)
    state = TrainState.create(w, ModelTrainConfig())
    steps = []
    for batch in batches:
        loss, metrics = train_step(state, {k: _rows(v, mesh) for k, v in batch.items()})
        steps.append(dict({k: float(v) for k, v in metrics.items()}, loss=float(loss)))
    with torch.no_grad():
        _, val, _ = w.loss_and_metrics({k: _rows(v, mesh) for k, v in batches[-1].items()}, None, False)
    return {"steps": steps, "val": {k: float(v) for k, v in val.items()},
            "params": {k: _np(v) for k, v in w.module.state_dict().items()}}


def main() -> int:
    job, rank, world, port = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(job, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, fn, kwargs in cases:
        results[name] = CASES[fn](**kwargs)
    with open(f"{job}.rank{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
