"""The port's checkpoints and supervisor on the CPU, and against the JAX
package's.

The twins of ``tests/test_fault_tolerance.py`` run on the port (all but
the elastic reshard onto a mesh, which waits for ROADMAP Queue 1 #13 and
raises naming it).  Then the two packages' ``save_tree`` write the same
files byte for byte for the same tree, and each ``load_tree`` reads the
other's.  Restarts are bit for bit: the same float32 operations replayed.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_tree as jax_load_tree
from repro.checkpoint import save_tree as jax_save_tree
from repro.models import transformer as JT
from repro.models.base import init_params as jax_init_params
from repro_torch.checkpoint import CheckpointManager, load_tree, save_tree
from repro_torch.data import StepLoader, lm_batch
from repro_torch.distributed import FailureInjector, TrainSupervisor, reshard_tree
from repro_torch.distributed.fault_tolerance import onto_devices_of
from repro_torch.launch.cells import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.base import params_from_jax
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves

CFG = T.LMConfig(
    name="ft", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
    vocab=128, d_head=16, max_seq=32, dtype=torch.float32, attn_chunk=16,
)


def _setup(tmp_path, ckpt_every=5, *, async_save=False):
    opt = adamw(1e-2)
    raw = make_train_step(lambda p, b: T.lm_loss(p, b, CFG), opt)

    def step_fn(state, batch, i):
        p, o = state
        p, o, m = raw(p, o, batch)
        return (p, o), m

    params = T.init_params(CFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    state = (params, opt.init(params))
    loader = StepLoader(make=lambda seed, step, shard=0: lm_batch(seed, step, batch=4, seq=32, vocab=128, shard=shard))
    ckpt = CheckpointManager(tmp_path / "ck", keep_n=2, async_save=async_save)
    sup = TrainSupervisor(step_fn=step_fn, loader=loader, ckpt=ckpt, ckpt_every=ckpt_every)
    return sup, state


# ------------------------------------------- twins of tests/test_fault_tolerance.py
def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": [np.ones(4, np.int64), (np.zeros(2, np.float16), np.asarray(3))],
        "t": torch.arange(5, dtype=torch.int32),
    }
    save_tree(str(tmp_path / "t"), tree, attrs={"step": 9})
    back, meta = load_tree(str(tmp_path / "t"))
    assert meta["step"] == 9
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert isinstance(back["b"][1], tuple)
    np.testing.assert_array_equal(back["b"][1][0], tree["b"][1][0])
    assert back["t"].dtype == np.int32 and back["t"].tolist() == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("async_save", [False, True])
def test_restart_is_bit_identical(tmp_path, async_save):
    """A run with two injected failures equals the failure-free run; the
    restored state is tensors again, on the state's device, before the
    step after each restart."""
    sup1, s1 = _setup(tmp_path / "clean", async_save=async_save)
    clean, stats1 = sup1.run(s1, 20)
    sup2, s2 = _setup(tmp_path / "faulty", async_save=async_save)
    seen = []
    step_fn = sup2.step_fn
    sup2.step_fn = lambda s, b, i: (seen.append({(type(x), x.device.type) for x in tree_leaves(s)}), step_fn(s, b, i))[1]
    inj = FailureInjector(fail_at={7: 1, 13: 1})
    faulty, stats2 = sup2.run(s2, 20, injector=inj)
    assert stats2["restarts"] == 2 and stats1["restarts"] == 0
    assert all(k == {(torch.Tensor, "cpu")} for k in seen), seen
    a, b = tree_leaves(clean), tree_leaves(faulty)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)


def test_retention_keeps_n(tmp_path):
    sup, s = _setup(tmp_path / "r", ckpt_every=2)
    sup.run(s, 10)
    assert len(sup.ckpt.steps()) <= 2


def test_too_many_failures_raises(tmp_path):
    sup, s = _setup(tmp_path / "x")
    sup.max_retries = 2
    inj = FailureInjector(fail_at={0: 99})
    with pytest.raises(RuntimeError):
        sup.run(s, 10, injector=inj)


def test_elastic_reshard_waits_for_the_distribution_layer():
    with pytest.raises(NotImplementedError, match="reshard_tree.*Queue 1 #13"):
        reshard_tree({}, None, {})


def test_loader_is_pure_in_step():
    loader = StepLoader(make=lambda seed, step, shard=0: lm_batch(seed, step, batch=2, seq=8, vocab=10, shard=shard))
    a = loader.global_batch(3)["tokens"]
    np.testing.assert_array_equal(a, loader.global_batch(3)["tokens"])
    assert not np.array_equal(a, loader.global_batch(4)["tokens"])
    two = StepLoader(make=loader.make, n_shards=2)
    np.testing.assert_array_equal(two.global_batch(3)["tokens"][:2], two.shard_batch(3, 0)["tokens"])


# ---------------------------------------------------------------- the port's own
def test_bf16_leaves_are_refused_as_the_reference_refuses_them(tmp_path):
    with pytest.raises(TypeError, match="unsupported dtype for fstore: bfloat16"):
        save_tree(str(tmp_path / "b"), {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="unsupported dtype for fstore"):
        jax_save_tree(str(tmp_path / "j"), {"w": jnp.ones(3, jnp.bfloat16)})
    ck = CheckpointManager(tmp_path / "ck")
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(1, {"w": torch.ones(3, dtype=torch.bfloat16)})


def test_async_save_copies_before_the_next_in_place_update(tmp_path):
    """save() takes its host copy on the calling thread: a CPU tensor
    updated in place right after still saves its old values."""
    w = torch.zeros(1 << 16)
    ck = CheckpointManager(tmp_path / "ck", async_save=True)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    back, step = ck.restore()
    assert step == 1 and not back["w"].any()


def test_async_save_failures_are_raised_on_wait(tmp_path):
    ck = CheckpointManager(tmp_path / "ck", async_save=True)
    ck.save(1, {"x": np.zeros(2)})
    ck.wait()
    (tmp_path / "ck" / "step_00000002.tmp").write_text("a file where a directory goes")
    os.chmod(tmp_path / "ck", 0o500)
    try:
        ck.save(2, {"x": np.zeros(2)})
        with pytest.raises(OSError):
            ck.wait()
    finally:
        os.chmod(tmp_path / "ck", 0o700)


def test_onto_devices_of_places_numpy_like_the_state():
    like = ({"w": torch.zeros(2), "n": 3}, [torch.zeros((), dtype=torch.int32)], None)
    back = onto_devices_of(({"w": np.ones(2, np.float32), "n": 3}, [np.asarray(7, np.int32)], None), like)
    assert isinstance(back[0]["w"], torch.Tensor) and back[0]["w"].dtype == torch.float32
    assert back[0]["n"] == 3 and back[2] is None
    assert back[1][0].dtype == torch.int32 and back[1][0].shape == () and int(back[1][0]) == 7


# ------------------------------------------------------- against the reference
def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_save_tree_files_byte_for_byte_across_packages(tmp_path):
    """A trainer state's shape of tree (nested dicts, a list of layers, a
    tuple, None, a 0-d int32 step, float16 and int32 leaves; jax holds no int64 by default): the two
    packages write the same files with the same bytes, and each reads the
    other's."""
    rng = np.random.default_rng(0)
    tree = ({"embed": rng.normal(size=(8, 4)).astype(np.float32),
             "layers": [{"w": rng.normal(size=(4, 4)).astype(np.float32), "g": np.ones(4, np.float32)}
                        for _ in range(2)]},
            {"mu": {"x": np.zeros((3, 5), np.float16)}, "step": np.asarray(7, np.int32),
             "ids": np.arange(6, dtype=np.int32)},
            None)
    torch_tree = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    save_tree(str(tmp_path / "port"), torch_tree, attrs={"step": 7})
    jax_save_tree(str(tmp_path / "ref"), jax.tree.map(jnp.asarray, tree), attrs={"step": 7})
    a, b = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert a[k] == b[k], k
    for load, root in ((load_tree, "ref"), (jax_load_tree, "port")):
        back, meta = load(str(tmp_path / root))
        assert meta == {"step": 7} and back[2] is None and isinstance(back, tuple)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert np.asarray(x).dtype == y.dtype and np.asarray(x).tobytes() == y.tobytes()


def test_reference_lm_params_checkpoint_loads_into_the_port(tmp_path):
    """The reference's stacked LM parameters, saved by the reference, load
    in the port and carry across to its per-layer layout unchanged."""
    jcfg = JT.LMConfig(name="ft", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                       vocab=128, d_head=16, max_seq=32, dtype=jnp.float32, attn_chunk=16)
    jp = jax_init_params(JT.param_specs(jcfg), jax.random.key(1))
    jax_save_tree(str(tmp_path / "e"), jp, attrs={"step": 0})
    back, _ = load_tree(str(tmp_path / "e"))
    tp = params_from_jax(back, CFG, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(tp["layers"][1]["wq"].numpy(), np.asarray(jp["layers"]["wq"][1]))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
