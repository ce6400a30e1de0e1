"""The port's ``WorkerPool`` accounting against the JAX package's under the
same random interleavings of request / release / resize, test for test with
``tests/test_pool_invariants.py``: both pools, driven in lockstep, hand out
the same grants and report the same capacity, use, debt, reserve and
per-domain ledgers after every operation, and the reference's invariants
hold on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


def _state(pool, domains=None):
    out = (pool.capacity, pool.in_use, pool.available, pool.shrink_debt, pool.high_priority_reserve)
    if domains:
        out += (list(pool.in_use_by_domain), list(pool.domain_capacities),
                [pool.shrink_debt_of(d) for d in range(domains)], [pool.available_in(d) for d in range(domains)])
    return out


class Lockstep:
    """The port's pool and the reference's, every call made on both; a call
    returns the port's result after checking that both agree."""

    def __init__(self, *args, domains=None, **kw):
        self.t, self.j = tcore.WorkerPool(*args, **kw), jcore.WorkerPool(*args, **kw)
        self.domains = domains
        if domains:
            self.t.set_domains(domains)
            self.j.set_domains(domains)

    def __call__(self, name, *args, **kw):
        got, want = getattr(self.t, name)(*args, **kw), getattr(self.j, name)(*args, **kw)
        assert got == want, (name, args, kw, got, want)
        assert _state(self.t, self.domains) == _state(self.j, self.domains)
        return got


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), capacity=st.integers(1, 32), reserve_frac=st.floats(0.0, 0.9))
def test_pool_invariants_under_random_interleavings(seed, capacity, reserve_frac):
    reserve = min(int(capacity * reserve_frac), capacity - 1)
    both = Lockstep(capacity, high_priority_reserve=reserve)
    pool = both.t
    rng = np.random.default_rng(seed)
    outstanding = []
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 2 * capacity + 1))
            grant = both("request", n, priority=int(rng.integers(0, 2)))
            assert 0 <= grant <= n
            if grant:
                outstanding.append(grant)
        elif op == 1 and outstanding:
            both("release", outstanding.pop(int(rng.integers(0, len(outstanding)))))
        elif op == 2:
            if outstanding:
                i = int(rng.integers(0, len(outstanding)))
                part = int(rng.integers(1, outstanding[i] + 1))
                both("release", part)
                if outstanding[i] == part:
                    outstanding.pop(i)
                else:
                    outstanding[i] -= part
        else:
            both("resize", int(rng.integers(1, 2 * capacity + 1)))
        held = sum(outstanding)
        assert pool.in_use == held
        assert pool.in_use <= pool.capacity + pool.shrink_debt
        assert pool.available == max(pool.capacity - held, 0)
        assert 0 <= pool.high_priority_reserve < pool.capacity or (
            pool.high_priority_reserve == 0 and pool.capacity == 1)
        assert pool.high_priority_reserve == min(reserve, pool.capacity - 1)
    for g in outstanding:
        both("release", g)
    assert pool.in_use == 0
    assert pool.available == pool.capacity
    assert both("request", 1, priority=0) == 1
    both("release", 1)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), capacity=st.integers(2, 32), domains=st.integers(2, 4))
def test_per_domain_invariants_under_random_interleavings(seed, capacity, domains):
    domains = min(domains, capacity)
    both = Lockstep(capacity, domains=domains)
    pool = both.t
    rng = np.random.default_rng(seed)
    outstanding = []
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            d = int(rng.integers(0, domains))
            n = int(rng.integers(1, capacity + 1))
            before = pool.in_use_in(d)
            grant = both("request", n, domain=d)
            assert 0 <= grant <= n
            assert pool.in_use_in(d) == before + grant
            if grant:
                outstanding.append((grant, d))
        elif op == 1:
            n = int(rng.integers(1, capacity + 1))
            by_before = list(pool.in_use_by_domain)
            grant = both("request", n)
            deltas = [a - b for a, b in zip(pool.in_use_by_domain, by_before)]
            assert sum(deltas) == grant
            for d, delta in enumerate(deltas):
                if delta > 0:
                    outstanding.append((delta, d))
        elif op == 2 and outstanding:
            g, d = outstanding.pop(int(rng.integers(0, len(outstanding))))
            both("release", g, domain=d)
        elif op == 3:
            both("resize", int(rng.integers(domains, 2 * capacity + 1)))
        else:
            both("resize_domain", int(rng.integers(0, domains)), int(rng.integers(1, capacity + 1)))
        by, caps = pool.in_use_by_domain, pool.domain_capacities
        assert len(by) == len(caps) == domains
        assert sum(by) == pool.in_use
        assert sum(caps) == pool.capacity
        for d in range(domains):
            assert by[d] >= 0
            assert caps[d] >= 1 or pool.shrink_debt_of(d) > 0
            assert by[d] <= caps[d] + pool.shrink_debt_of(d)
            assert pool.available_in(d) == max(caps[d] - by[d], 0)
    for g, d in outstanding:
        both("release", g, domain=d)
    assert pool.in_use == 0
    assert all(u == 0 for u in pool.in_use_by_domain)
