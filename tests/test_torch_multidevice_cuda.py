"""The multi-device layers on the card: two gloo worker processes on the one
card (NCCL refuses two ranks on one GPU) run the collectives on CUDA
tensors (through the host, on gloo, returning CUDA tensors), ring attention
and both lookup schedules of the row-sharded table, each held to the same
workers' run on the CPU; and a one-rank NCCL group in this process runs
the collectives' NCCL path on the card.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_multidevice_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import datetime
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist import free_port, start_workers  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _cases(device):
    b, h, t, d, nk = 4, 2, 27, 8, 32
    ring = dict(model=2, causal=True, q=_normal(1, (b, h, t, d)), k=_normal(2, (b, 1, t, d)),
                v=_normal(3, (b, 1, t, d)), co=_normal(4, (b, h, t, d)), tab=_normal(5, (2 * nk + 1, h), 0.3), nk=nk,
                device=device)
    ids = np.random.RandomState(3).randint(-(2**62), 2**62, size=(16, 6), dtype=np.int64)
    lookups = {s: dict(model=2, schedule=s, table=_normal(0, (1024, 32)), ids=ids, num_shifts=5,
                       target=_normal(9, (16, 6, 32)), device=device) for s in ("psum", "alltoall")}
    return [("collectives", "collectives", dict(device=device)), ("ring", "ring", ring),
            *((f"lookup_{s}", "lookup", c) for s, c in lookups.items())]


@pytest.fixture(scope="module")
def runs(cuda):
    on_card = start_workers(_cases("cuda"), 2, timeout=240)
    on_cpu = start_workers(_cases("cpu"), 2, timeout=240)
    return on_card.results(), on_cpu.results()


def test_gloo_collectives_take_cuda_tensors(runs):
    card, cpu = runs
    for r in range(2):
        assert card[r]["collectives"]["devices"] == ["cuda:0"]
        for k, v in cpu[r]["collectives"].items():
            if k != "devices":
                np.testing.assert_array_equal(card[r]["collectives"][k], v, err_msg=k)


@pytest.mark.parametrize("name", ["ring", "lookup_psum", "lookup_alltoall"])
def test_ring_and_sharded_lookups_on_the_card_match_the_cpu(runs, name):
    card, cpu = runs
    for r in range(2):
        assert card[r][name]["device"].startswith("cuda")
        for k, v in cpu[r][name].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(card[r][name][k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_one_rank_nccl_group_runs_the_collectives(cuda):
    """A one-rank NCCL group: each collective's NCCL call on CUDA tensors
    (the values are this rank's own)."""
    from recommendations_tpu_torch.core.mesh import Mesh
    from recommendations_tpu_torch.parallel import collectives as col

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60), device_id=torch.device("cuda", 0))
    try:
        group = dist.group.WORLD
        mesh = Mesh.one_rank(group, "cuda")
        assert mesh.group("data") is group and dist.get_backend(group) == "nccl"
        x = torch.arange(8, dtype=torch.float32, device=cuda)
        for fn in (col.all_gather_tensor, col.all_to_all_tensor):
            y = fn(x, group)
            assert y.is_cuda and torch.equal(y, x)
        y = x.clone().requires_grad_()
        (col.psum(y, group) * 2).sum().backward()
        assert torch.equal(y.grad, torch.full_like(x, 2.0))
        assert col.any_rank([False, True], group) == [False, True]
    finally:
        dist.destroy_process_group()
