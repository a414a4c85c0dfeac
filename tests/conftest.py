"""Test-session setup: src/ on sys.path and a gate for optional deps.

``hypothesis`` is optional: when the real library is installed it is used
unchanged; otherwise a minimal deterministic stand-in is registered so the
property tests still run (strategy corner values + a fixed pseudo-random
sample of the strategy space) instead of failing at collection. CI pins
real hypothesis; the stand-in keeps bare-container runs green.
"""

import os
import random
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _install_hypothesis_stub() -> None:
    class _Strategy:
        """Deterministic stand-in: ``corners()`` lists boundary examples,
        ``sample(rng)`` draws from the interior."""

        def corners(self):
            return []

        def sample(self, rng):
            raise NotImplementedError

        def map(self, f):
            return _Mapped(self, f)

        def flatmap(self, f):
            return _FlatMapped(self, f)

    class _Integers(_Strategy):
        def __init__(self, lo, hi):
            self.lo, self.hi = int(lo), int(hi)

        def corners(self):
            return [self.lo, self.hi]

        def sample(self, rng):
            return rng.randint(self.lo, self.hi)

    class _Just(_Strategy):
        def __init__(self, value):
            self.value = value

        def corners(self):
            return [self.value]

        def sample(self, rng):
            return self.value

    class _SampledFrom(_Strategy):
        def __init__(self, seq):
            self.seq = list(seq)

        def corners(self):
            return [self.seq[0], self.seq[-1]]

        def sample(self, rng):
            return rng.choice(self.seq)

    class _Tuples(_Strategy):
        def __init__(self, *strats):
            self.strats = strats

        def corners(self):
            lows = tuple(s.corners()[0] for s in self.strats)
            highs = tuple(s.corners()[-1] for s in self.strats)
            return [lows, highs]

        def sample(self, rng):
            return tuple(s.sample(rng) for s in self.strats)

    class _Mapped(_Strategy):
        def __init__(self, base, f):
            self.base, self.f = base, f

        def corners(self):
            return [self.f(c) for c in self.base.corners()]

        def sample(self, rng):
            return self.f(self.base.sample(rng))

    class _FlatMapped(_Strategy):
        def __init__(self, base, f):
            self.base, self.f = base, f

        def corners(self):
            out = []
            for c in self.base.corners():
                out.extend(self.f(c).corners())
            return out

        def sample(self, rng):
            return self.f(self.base.sample(rng)).sample(rng)

    strategies = types.ModuleType("hypothesis.strategies")
    strategies.integers = lambda min_value, max_value: _Integers(min_value,
                                                                 max_value)
    strategies.just = _Just
    strategies.sampled_from = _SampledFrom
    strategies.tuples = _Tuples

    def given(*strats):
        def deco(fn):
            # cap examples: the stand-in hits all corners anyway and
            # unjitted CPU examples are slow
            n = min(getattr(fn, "_max_examples", 12), 12)

            def run():
                examples = []
                for i in range(max(len(s.corners()) for s in strats)):
                    examples.append(tuple(
                        s.corners()[min(i, len(s.corners()) - 1)]
                        for s in strats))
                rng = random.Random(0)
                while len(examples) < n:
                    examples.append(tuple(s.sample(rng) for s in strats))
                for args in examples[:max(n, 2)]:
                    fn(*args)

            run.__name__ = fn.__name__
            run.__doc__ = fn.__doc__
            return run

        return deco

    def settings(max_examples=None, deadline=None, **_kw):
        def deco(fn):
            if max_examples is not None:
                fn._max_examples = max_examples
            return fn

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.strategies = strategies
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strategies


try:
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skipped from inside the test "
        "when torch.cuda.is_available() is false)")
