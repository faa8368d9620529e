import os

# Smoke tests and benches must see the single real CPU device — the 512-way
# host-device forcing belongs ONLY to launch/dryrun.py (see system design).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# ---------------------------------------------------------------------------
# Optional-dependency shim: hypothesis.
#
# Five test modules are property tests written against hypothesis.  The
# package is optional in this container; without it, a hard import would
# abort collection for the whole suite.  When hypothesis is missing we
# install a deterministic fallback into sys.modules: @given runs the test
# over a fixed, seeded set of examples (boundary values first, then
# pseudo-random draws from the declared ranges).  Coverage is thinner than
# real hypothesis but deterministic and dependency-free; with hypothesis
# installed this shim is inert.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import inspect
    import itertools
    import random
    import sys
    import types

    _DEFAULT_EXAMPLES = 25
    _MAX_EXAMPLES_CAP = 25

    class _UnsatisfiedAssumption(Exception):
        """Raised by assume(False): skip the current example, not fail."""

    def _assume(condition):
        if not condition:
            raise _UnsatisfiedAssumption()
        return True

    class _Strategy:
        def __init__(self, sample):
            self._sample = sample          # (rng, index) -> value

        def example_at(self, rng, i):
            return self._sample(rng, i)

    def _integers(min_value=0, max_value=2**31 - 1):
        lo, hi = int(min_value), int(max_value)

        def sample(rng, i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            return rng.randint(lo, hi)

        return _Strategy(sample)

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        lo, hi = float(min_value), float(max_value)

        def sample(rng, i):
            if i == 0:
                return lo
            if i == 1:
                return hi
            return rng.uniform(lo, hi)

        return _Strategy(sample)

    def _sampled_from(elements):
        elems = list(elements)

        def sample(rng, i):
            if i < len(elems):
                return elems[i]
            return elems[rng.randrange(len(elems))]

        return _Strategy(sample)

    def _booleans():
        return _sampled_from([False, True])

    def _just(value):
        return _Strategy(lambda rng, i: value)

    def _lists(elements, min_size=0, max_size=10):
        lo, hi = int(min_size), int(max_size)

        def sample(rng, i):
            if i == 0:
                size = lo
            elif i == 1:
                size = hi
            else:
                size = rng.randint(lo, hi)
            return [elements.example_at(rng, i) for _ in range(size)]

        return _Strategy(sample)

    def _tuples(*strategies):
        def sample(rng, i):
            return tuple(s.example_at(rng, i) for s in strategies)

        return _Strategy(sample)

    def _one_of(*strategies):
        # accept both one_of(a, b) and one_of([a, b])
        strats = (
            list(strategies[0])
            if len(strategies) == 1 and isinstance(strategies[0], (list, tuple))
            else list(strategies)
        )

        def sample(rng, i):
            if i < len(strats):
                return strats[i].example_at(rng, i)
            return strats[rng.randrange(len(strats))].example_at(rng, i)

        return _Strategy(sample)

    def _none():
        return _just(None)

    def _text(alphabet="abcdefghijklmnopqrstuvwxyz", min_size=0, max_size=8):
        chars = list(alphabet)
        lo, hi = int(min_size), int(max_size)

        def sample(rng, i):
            size = lo if i == 0 else (hi if i == 1 else rng.randint(lo, hi))
            return "".join(chars[rng.randrange(len(chars))] for _ in range(size))

        return _Strategy(sample)

    def _settings(**kw):
        def deco(fn):
            fn._shim_settings = dict(getattr(fn, "_shim_settings", {}), **kw)
            return fn

        return deco

    def _given(*pos_strategies, **kw_strategies):
        def deco(fn):
            params = [
                p.name
                for p in inspect.signature(fn).parameters.values()
                if p.kind
                in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY, p.KEYWORD_ONLY)
            ]
            bound = dict(kw_strategies)
            if pos_strategies:
                # hypothesis fills positional strategies against the
                # rightmost parameters, in order
                names = [n for n in params if n not in bound]
                tail = names[-len(pos_strategies):]
                bound.update(zip(tail, pos_strategies))

            def wrapper():
                cfg = getattr(wrapper, "_shim_settings", {}) or getattr(
                    fn, "_shim_settings", {}
                )
                n = min(
                    int(cfg.get("max_examples", _DEFAULT_EXAMPLES)),
                    _MAX_EXAMPLES_CAP,
                )
                rng = random.Random(f"repro-shim:{fn.__module__}.{fn.__qualname__}")
                for i in range(n):
                    kwargs = {
                        name: strat.example_at(rng, i)
                        for name, strat in bound.items()
                    }
                    try:
                        fn(**kwargs)
                    except _UnsatisfiedAssumption:
                        continue
                    except Exception as e:
                        raise AssertionError(
                            f"falsifying example (deterministic shim, "
                            f"case {i}): {kwargs!r}"
                        ) from e

            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__module__ = fn.__module__
            wrapper.__doc__ = fn.__doc__
            wrapper._shim_settings = dict(getattr(fn, "_shim_settings", {}))
            wrapper.hypothesis_shim = True
            return wrapper

        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.assume = _assume
    _hyp.__is_repro_shim__ = True
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans
    _st.just = _just
    _st.lists = _lists
    _st.tuples = _tuples
    _st.one_of = _one_of
    _st.none = _none
    _st.text = _text
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips without one",
    )
