import os
import sys
from pathlib import Path

# benchmarks package (repo root) importable from tests
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# Tests must see ONE device (the dry-run owns the 512-device flag).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


# --------------------------------------------------------------------------
# hypothesis fallback shim: the property tests (test_fstore / test_kernels /
# test_optim) must stay collectable when hypothesis isn't installed.  The
# shim runs each @given test as a small deterministic example sweep instead
# of failing at import.  Real hypothesis, when present, wins untouched.
try:  # pragma: no cover - trivially true when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    import inspect
    import random
    import types

    _N_FALLBACK_EXAMPLES = 10  # bounded sweep; real hypothesis does 15-25

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng):
            return self._draw(rng)

    class _DataObject:
        """Stand-in for st.data()'s interactive draw object."""

        def __init__(self, rng):
            self._rng = rng

        def draw(self, strategy, label=None):
            return strategy.draw(self._rng)

    _DATA_SENTINEL = object()

    def _integers(min_value=0, max_value=2**31):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _floats(min_value=-1e6, max_value=1e6, **_kw):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def _booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng: seq[rng.randrange(len(seq))])

    def _data():
        s = _Strategy(lambda rng: _DataObject(rng))
        s._is_data = _DATA_SENTINEL
        return s

    def _given(*pos_strategies, **kw_strategies):
        def deco(fn):
            sig = inspect.signature(fn)
            params = list(sig.parameters)
            # positional strategies bind to the RIGHTMOST params (hypothesis
            # semantics); remaining leading params stay pytest fixtures
            kw = dict(kw_strategies)
            for name, strat in zip(params[len(params) - len(pos_strategies):], pos_strategies):
                kw[name] = strat
            fixture_params = [p for p in params if p not in kw]

            def runner(*args, **fixtures):
                n = getattr(runner, "_hyp_max_examples", _N_FALLBACK_EXAMPLES)
                n = min(n, _N_FALLBACK_EXAMPLES)
                for ex in range(n):
                    rng = random.Random(0xECF5 + 7919 * ex)
                    drawn = {name: strat.draw(rng) for name, strat in kw.items()}
                    fn(*args, **fixtures, **drawn)

            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            runner.__module__ = fn.__module__
            runner.__signature__ = sig.replace(
                parameters=[sig.parameters[p] for p in fixture_params]
            )
            return runner

        return deco

    def _settings(max_examples=None, **_kw):
        def deco(fn):
            if max_examples is not None:
                fn._hyp_max_examples = max_examples
            return fn

        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.data = _data
    _hyp.strategies = _st
    _hyp.__is_repro_shim__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode); "
        "skipped without one",
    )
