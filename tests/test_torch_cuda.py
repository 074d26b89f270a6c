"""The port's CUDA kernels on the card.  Every test here carries the ``cuda``
marker and skips without a GPU: a kernel written in CUDA has no CPU mode.
No JAX here, so the file runs where the card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.distance_topk import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _calls(device, seed=0):
    """Kernel calls whose workspaces differ in size, so that threads running
    them at once grow the shared (device, stream) workspace under each
    other: key lists past the first 1 MiB, more than 1024 counters."""
    g = torch.Generator().manual_seed(seed)
    D = 128
    calls = []
    for G, N, k in ((32, 455, 100), (128, 5360, 128), (256, 2048, 256), (1500, 300, 64), (64, 700, 700)):
        codes = torch.randint(-128, 128, (G, N, D), generator=g, dtype=torch.int8)
        n_rows = torch.randint(0, N + 1, (G,), generator=g, dtype=torch.int32)
        args = (torch.randn(G, D, generator=g), codes, torch.rand(G, generator=g) * 0.01 + 1e-3,
                torch.randn(G, generator=g) * 0.01, n_rows)
        calls.append(("grouped", tuple(t.to(device) for t in args), k, "cosine"))
    for B, N, k in ((1, 5632, 5632), (8, 1024, 1024), (2048, 512, 512), (16, 4096, 100)):
        args = (torch.randn(B, D, generator=g), torch.randn(N, D, generator=g))
        calls.append(("full" if k >= N else "merge", tuple(t.to(device) for t in args), k, "l2"))
    return calls


def _run(call):
    kind, args, k, metric = call
    if kind == "grouped":
        return ops.grouped_distance_topk_tensors(*args, k, metric, "int8")
    return ops.distance_topk(*args, k, metric)


def test_threads_sharing_the_default_stream_match_the_calls_run_alone(card):
    """4 threads launch both distance kernels on the one default stream they
    share, at shapes that grow the shared workspace while other threads hold
    it: every result is bit-identical to the same call run alone."""
    calls = _calls(card)
    ops.workspaces.clear()
    alone = [_run(c) for c in calls]
    torch.cuda.synchronize()
    ops.workspaces.clear()  # start small again: the threads grow it
    got: dict = {}
    errors: list = []

    def worker(t):
        try:
            for rep in range(3):
                for i in range(t, len(calls), 4):
                    got[(rep, i)] = _run(calls[i])
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 3 * len(calls)
    for (rep, i), (d, idx) in got.items():
        np.testing.assert_array_equal(d.cpu().numpy(), alone[i][0].cpu().numpy(), err_msg=f"call {i} rep {rep}")
        np.testing.assert_array_equal(idx.cpu().numpy(), alone[i][1].cpu().numpy(), err_msg=f"call {i} rep {rep}")
    ws = next(iter(ops.workspaces.values()))
    assert len(ops.workspaces) == 1 and int(ws[1].abs().sum()) == 0  # one workspace, counters at rest


def test_candidate_scores_on_the_card_is_one_launch_of_the_split_path(card):
    """The recsys tower's scoring at B = 1 on the card: one launch of the
    k < N path, the plain version's top 100 (scores within 1e-4 * max(1,
    |s|), ids equal but among such near-equal scores), the tail block's
    last row found first, every finish counter back at 0."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.models import recsys

    g = torch.Generator().manual_seed(5)
    for N, d in ((200_000, 18), (200_003, 32), (1000, 16)):
        q, cand = torch.randn(1, d, generator=g), torch.randn(N, d, generator=g)
        cand[-1] = q[0] * 50
        q, cand = q.to(card), cand.to(card)
        ops.reset_launches()
        s, i = recsys.candidate_scores(q, cand, 100)
        assert ops.launches["distance_topk"] == 1
        assert s.shape == i.shape == (1, 100) and i.dtype == torch.int32 and s.device == card
        d0, i0 = distance_topk_ref(q, cand, 100, "ip")
        s, i, s0, i0 = s.cpu().numpy(), i.cpu().numpy(), -d0.cpu().numpy(), i0.cpu().numpy()
        tol = 1e-4 * np.maximum(1.0, np.abs(s0))
        assert (np.abs(s - s0) <= tol).all()
        for j in np.flatnonzero(i[0] != i0[0]):
            hit = np.flatnonzero(i0[0] == i[0, j])
            ref = s0[0, hit[0]] if len(hit) else s0[0, -1]
            assert abs(s[0, j] - ref) <= 2e-4 * max(1.0, abs(ref)), (N, d, j)
        assert int(i[0, 0]) == N - 1
    torch.cuda.synchronize()
    for _, counters in ops.workspaces.values():
        assert int(torch.count_nonzero(counters)) == 0
