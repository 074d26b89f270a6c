"""The port's dry run (``repro_torch.launch.dryrun``) on this CPU: full-size
LM serving cells traced on fake tensors, held against the reference's
cells, the search for a batch that fits, and the kernels' custom ops under
fake tensors.  (The LM train cell's trace is in
``tests/test_torch_cells_lm.py``, the GraphSAGE and recsys cells' in
``tests/test_torch_cells_gnn_recsys.py``: the ledger runs a file on one
worker.)

Held exactly against the reference's cell (``mesh_axes=None``):
``n_params``, ``arg_bytes`` (the abstract args' bytes at their dtypes),
``tokens`` and ``n_candidates``.  The traced FLOPs against
``benchmarks/analytic.cell_flops``, by kind, bands derived from what each
counts (relative 1e-3 where the two count the same products):
  * decode, retrieval_decode: the same products, equal; but an MoE
    layer's experts run over all E x C capacity slots (the reference's
    dispatch: C = max(1, int(1.25 T / E)) a token count T; at batch 1
    every expert computes one slot), where the analytic count takes the
    T routed tokens: traced = analytic + 6 D F_e (E C - T) a MoE layer.
  * prefill: the port's chunked attention computes every [q block, all
    keys] product, the full S² where the analytic count takes S²/2, and
    its prefill projects only the last position onto the vocabulary:
    traced = analytic + attention - logits * (S - 1) / S.
  * train: the analytic count is four passes (forward, remat's
    re-forward, a backward of two); the traced one counts what runs.
    torch's checkpoint stops a recomputation at the last tensor the
    backward needs, and the logits are outside the layers' remat, so at
    least three passes (0.75); attention at most five passes of the full
    S² (forward, the layer's and the block's recomputation, a backward of
    two) against the analytic four of S²/2: at most analytic + 1.5 x its
    attention.
The peaks are the port's own (the reference's come from XLA's sharded
compile) and are not held against it.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import analytic
from repro.configs import arch_shapes
from repro.launch import cells as RC
from repro.models import transformer as RT
from repro.models.base import param_bytes as param_bytes_ref
from repro_torch.kernels.distance_topk import ops as topk_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.models.base import param_bytes
from repro_torch.models.moe import capacity

SAME = 1e-3


def ref_record(arch: str, shape: str) -> dict:
    """The reference's counts of its cell on one device."""
    import jax

    rc = RC.build_cell(arch, shape, mesh_axes=None)
    sh = dict(arch_shapes(arch)[shape])
    return {"n_params": rc.meta["n_params"], "tokens": rc.meta.get("tokens", 0),
            "n_candidates": rc.meta.get("n_candidates", 0),
            "arg_bytes": sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(rc.args)),
            "meta": rc.meta, "sh": sh}


def held_counts(rec: dict, ref: dict) -> None:
    for k in ("n_params", "arg_bytes", "tokens", "n_candidates"):
        assert rec[k] == ref[k], (k, rec[k], ref[k])


def analytic_band(ref: dict) -> tuple[float, float]:
    meta, sh = ref["meta"], ref["sh"]
    total = analytic.cell_flops(meta, sh["kind"], sh)
    if meta["family"] != "lm":
        raise ValueError(meta["family"])
    cfg = meta["cfg"]
    f = analytic.lm_cell_flops(cfg, sh["kind"], sh["batch"], sh["seq"])
    if sh["kind"] in ("decode", "retrieval_decode"):
        if cfg.moe is not None:
            T, E = sh["batch"], cfg.moe.n_experts
            n_moe = cfg.n_layers // cfg.moe_every
            total += n_moe * 6 * cfg.d_model * cfg.moe.d_ff * (E * capacity(cfg.moe, T) - T)
        return total * (1 - SAME), total * (1 + SAME)
    if sh["kind"] == "prefill":
        want = total + f["attn"] - f["logits"] * (sh["seq"] - 1) / sh["seq"]
        return want * (1 - SAME), want * (1 + SAME)
    return 0.75 * total, total + 1.5 * f["attn"]


LM = [("qwen2-7b", "prefill_32k"), ("mistral-large-123b", "decode_32k"),
      ("llama4-maverick-400b-a17b", "long_500k"), ("llama4-scout-17b-a16e", "decode_32k")]


@pytest.mark.parametrize("arch,shape", LM, ids=[f"{a}-{s}" for a, s in LM])
def test_full_size_lm_cell_traces_as_the_reference_counts(arch, shape):
    ref = ref_record(arch, shape)
    rec = dryrun.run_cell(arch, shape, batch=ref["sh"]["batch"], verbose=False)
    held_counts(rec, ref)
    cfg = get_arch(arch)[1]
    assert rec["param_bytes"] == param_bytes(T.param_specs(cfg)) == param_bytes_ref(RT.param_specs(ref["meta"]["cfg"]))
    lo, hi = analytic_band(ref)
    assert lo <= rec["flops_traced"] <= hi, (rec["flops_traced"], lo, hi)
    assert rec["peak_bytes"] >= rec["arg_bytes"]   # the args are live throughout
    assert rec["fits_h100"] == (rec["peak_bytes"] <= dryrun.H100_FIT_BYTES)
    assert "fit_batch" not in rec                  # searched only at the shape's own batch


def test_fit_batch_halves_the_batch_until_the_trace_fits():
    """phi4-mini's decode_32k: 128 sequences of a 4.3 GB cache do not fit;
    8 do (the float32 weights, 17.8 GB, and 8 caches), 16 do not."""
    rec = dryrun.run_cell("phi4-mini-3.8b", "decode_32k", verbose=False)
    assert not rec["fits_h100"] and rec["fit_batch"] == 8
    assert rec["fit_peak_bytes"] <= dryrun.H100_FIT_BYTES
    assert not dryrun.run_cell("phi4-mini-3.8b", "decode_32k", batch=16, verbose=False)["fits_h100"]
    # args alone past the limit at the smallest batch: no fit, without a trace of it
    rec = dryrun.run_cell("phi4-mini-3.8b", "long_500k", verbose=False)
    assert rec["arg_bytes"] > dryrun.H100_FIT_BYTES and rec["fit_batch"] is None and rec["fit_peak_bytes"] is None


@pytest.mark.parametrize("causal", [True, False])
def test_flash_custom_op_traces_on_fake_tensors(causal):
    flash_ops.reset_launches()
    with FakeTensorMode():
        q = torch.empty((2, 28, 1024, 128), dtype=torch.bfloat16, device="meta")
        k = torch.empty((2, 4, 2048, 128), dtype=torch.bfloat16, device="meta")
        lens = torch.empty((2,), dtype=torch.int32, device="meta")
        with FlopCounterMode(display=False) as fc:
            o = flash_ops.flash_attention(q, k, k, kv_lens=lens, causal=causal)
        n = fc.get_total_flops()
        with pytest.raises(TypeError, match="one dtype"):   # the wrapper's checks run before the op
            flash_ops.flash_attention(q.float(), k, k)
    assert o.shape == (2, 28, 1024, 128) and o.dtype == torch.float32 and o.device.type == "meta"
    full = 4 * 2 * 28 * 1024 * 2048 * 128
    assert n == (full // 2 if causal else full)
    assert not any(flash_ops.launches.values())


@pytest.mark.parametrize("k", [100, 1000])
def test_distance_topk_custom_op_traces_on_fake_tensors(k):
    """Both paths (k < N and full selection) allocate ([B, k] float32,
    [B, k] int32) and count the distance products 2·B·N·D."""
    topk_ops.reset_launches()
    with FakeTensorMode():
        q = torch.empty((3, 32), device="meta")
        c = torch.empty((1000, 32), device="meta")
        with FlopCounterMode(display=False) as fc:
            d, i = topk_ops.distance_topk(q, c, k, "ip")
        n = fc.get_total_flops()
    assert d.shape == i.shape == (3, k) and d.dtype == torch.float32 and i.dtype == torch.int32
    assert n == 2 * 3 * 1000 * 32
    assert topk_ops.launches["distance_topk"] == 0
    # on the CPU the wrapper still takes the plain version, with no op in between
    g = np.random.default_rng(0)
    qc, cc = torch.from_numpy(g.standard_normal((3, 32), np.float32)), torch.from_numpy(
        g.standard_normal((1000, 32), np.float32))
    with FlopCounterMode(display=False) as fc:
        d, i = topk_ops.distance_topk(qc, cc, k, "ip")
    assert torch.ops.repro_torch.distance_topk not in fc.get_flop_counts()["Global"]
    assert d.shape == (3, k) and topk_ops.launches["distance_topk"] == 0
