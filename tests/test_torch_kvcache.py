"""The port's paged KV pool (deeplearning4j_tpu_torch/serving/kvcache.py)
against the JAX package's: the op sequences of tests/test_transformer.py's
``TestKVPagePool``, ``TestKVPoolPrefixSharing`` and ``TestKVPoolTruncate``
run on both pools, and every result, every ``describe()`` and every leaf
read back must be equal (the pools hold host numpy rows; nothing is
rounded). A hypothesis sweep does the same for random op sequences.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu.serving import kvcache as jkv
from deeplearning4j_tpu_torch.serving import kvcache as tkv

V = 23


def _ids(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).integers(0, V, n)]


def _kv_leaves(ids, extent=32, heads=2, dh=2):
    """A pageable [1, extent, H, dh] leaf whose rows encode (token,
    position), and a position carry (as tests/test_transformer.py)."""
    k = np.zeros((1, extent, heads, dh), np.float32)
    for j, tok in enumerate(ids):
        k[0, j] = float(tok) + j / 100.0
    return [k, np.array([len(ids)], np.int32)]


class Trace:
    """Records what a pool answers, op by op, with its describe() after
    each mutating op."""

    def __init__(self, pool):
        self.pool = pool
        self.out = []

    def __call__(self, op, *args, **kw):
        fn = getattr(self.pool, op)
        try:
            res = fn(*args, **kw)
        except Exception as e:  # the same refusal on both sides
            res = ("raised", type(e).__name__)
        self.out.append((op, res))
        if op in ("put", "drop", "match_prefix", "truncate"):
            self.out.append(("describe", self.pool.describe()))
        return res


def _same(a, b, where="trace"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


# ---- the JAX tests' op sequences, one function each, run on either pool
def pages_for_ceil(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=16)
    for n in (1, 16, 17, 0):
        t("pages_for", n)


def lru_eviction_and_miss_signal(P, t):
    t.pool = P.KVPagePool(n_pages=4, page_tokens=4)
    t("put", "a", 8, "A")
    t("put", "b", 8, "B")
    t("get", "a")
    t("put", "c", 4, "C")
    for sid in ("b", "a", "c"):
        t("get", sid)


def recharge_grows_in_place(P, t):
    t.pool = P.KVPagePool(n_pages=4, page_tokens=4)
    t("put", "a", 4, "A1")
    t("put", "a", 8, "A2")
    t("get", "a")


def session_larger_than_pool_raises(P, t):
    t.pool = P.KVPagePool(n_pages=4, page_tokens=4)
    t("put", "x", 17, "X")


def drop_and_occupancy(P, t):
    t.pool = P.KVPagePool(n_pages=4, page_tokens=4)
    t("put", "a", 8, "A")
    t("drop", "a")
    t("drop", "a")


def shared_prefix_pages_stored_once(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(8, seed=60)
    t("put", "s1", 8, _kv_leaves(ids), ids=ids)
    t("put", "s2", 8, _kv_leaves(ids), ids=ids)
    t("get", "s1")
    t("get", "s2")


def evict_while_shared_keeps_pages_for_survivor(P, t):
    t.pool = P.KVPagePool(n_pages=3, page_tokens=4)
    ids, other, third = _ids(8, seed=61), _ids(4, seed=62), _ids(4, seed=63)
    t("put", "s1", 8, _kv_leaves(ids), ids=ids)
    t("put", "s3", 4, _kv_leaves(other), ids=other)
    t("put", "s2", 8, _kv_leaves(ids), ids=ids)
    t("put", "s4", 4, _kv_leaves(third), ids=third)
    for sid in ("s1", "s3", "s2"):
        t("get", sid)


def last_holder_drop_frees_shared_pages(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(8, seed=64)
    t("put", "s1", 8, _kv_leaves(ids), ids=ids)
    t("put", "s2", 8, _kv_leaves(ids), ids=ids)
    t("drop", "s1")
    t("get", "s2")
    t("drop", "s2")


def cow_divergence_mid_page(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    a = _ids(6, seed=65)
    b = list(a[:5]) + [(a[5] + 1) % V]
    t("put", "a", 6, _kv_leaves(a), ids=a)
    t("put", "b", 6, _kv_leaves(b), ids=b)
    a2, b2 = a + [_ids(2, seed=66)[0]] * 2, b + [_ids(2, seed=67)[0]] * 2
    t("put", "a", 8, _kv_leaves(a2), ids=a2)
    t("put", "b", 8, _kv_leaves(b2), ids=b2)
    t("get", "a")
    t("get", "b")


def match_prefix_adopts_chain(P, t):
    t.pool = P.KVPagePool(n_pages=16, page_tokens=4)
    ids = _ids(12, seed=68)
    t("put", "s1", 12, _kv_leaves(ids), ids=ids)
    t("match_prefix", "s2", ids)
    t("match_prefix", "s3", ids, align_tokens=8)
    t("match_prefix", "s4", _ids(12, seed=69))
    t("drop", "s1")


def match_prefix_on_own_live_session(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(9, seed=74)
    t("put", "a", 9, _kv_leaves(ids), ids=ids)
    t("match_prefix", "a", ids)
    t("get", "a")


def put_without_ids_stays_dense(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(8, seed=70)
    t("put", "s1", 8, _kv_leaves(ids))
    t("put", "s2", 8, _kv_leaves(ids))
    t("match_prefix", "s3", ids)


def mid_page_truncate(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(10, seed=71)
    t("put", "a", 10, _kv_leaves(ids), ids=ids)
    t("truncate", "a", 6, others={1: np.array([6], np.int32)})
    t("get", "a")


def truncate_refcounted_shared_pages_survive(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(8, seed=72)
    t("put", "a", 8, _kv_leaves(ids), ids=ids)
    t("put", "b", 8, _kv_leaves(ids), ids=ids)
    t("truncate", "a", 4)
    t("get", "b")
    t("get", "a")


def truncate_rejects_dense_grow_and_unknown(P, t):
    t.pool = P.KVPagePool(n_pages=8, page_tokens=4)
    ids = _ids(8, seed=73)
    t("put", "d", 8, _kv_leaves(ids))
    t("truncate", "d", 4)
    t("truncate", "ghost", 4)
    t("put", "s", 8, _kv_leaves(ids), ids=ids)
    for n in (9, 0, 8):
        t("truncate", "s", n)


SCENARIOS = [pages_for_ceil, lru_eviction_and_miss_signal,
             recharge_grows_in_place, session_larger_than_pool_raises,
             drop_and_occupancy, shared_prefix_pages_stored_once,
             evict_while_shared_keeps_pages_for_survivor,
             last_holder_drop_frees_shared_pages, cow_divergence_mid_page,
             match_prefix_adopts_chain, match_prefix_on_own_live_session,
             put_without_ids_stays_dense, mid_page_truncate,
             truncate_refcounted_shared_pages_survive,
             truncate_rejects_dense_grow_and_unknown]


def _run(scenario, P):
    t = Trace(P.KVPagePool(n_pages=8, page_tokens=4))
    scenario(P, t)
    t.out.append(("describe", t.pool.describe()))
    t.out.append(("counters", [t.pool.evictions, t.pool.evicted_pages,
                               t.pool.page_hits, t.pool.prefix_matches,
                               t.pool.truncations, t.pool.truncated_pages,
                               t.pool.pages_used, t.pool.occupancy,
                               t.pool.sessions]))
    return t.out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_op_sequence_matches_jax_pool(scenario):
    _same(_run(scenario, tkv), _run(scenario, jkv))


def test_trace_sees_the_jax_tests_key_facts():
    """A spot check that the traces carry what the JAX tests assert: the
    shared prefix is stored once (dedup 2.0), and LRU eviction frees the
    least recently used session."""
    out = dict(_run(shared_prefix_pages_stored_once, tkv)[-2:])
    d = out["describe"]
    assert d["pages_used"] == 2 and d["dedup_ratio"] == 2.0
    lru = _run(lru_eviction_and_miss_signal, tkv)
    gets = [r for op, r in lru if op == "get"]
    assert gets == ["A", None, "A", "C"]


OPS = st.one_of(
    st.tuples(st.just("put"), st.sampled_from("abcd"),
              st.integers(1, 20), st.integers(0, 3), st.booleans()),
    st.tuples(st.just("get"), st.sampled_from("abcd")),
    st.tuples(st.just("drop"), st.sampled_from("abcd")),
    st.tuples(st.just("match_prefix"), st.sampled_from("abcd"),
              st.integers(1, 20), st.integers(0, 3),
              st.sampled_from([None, 4, 8])),
    st.tuples(st.just("truncate"), st.sampled_from("abcd"),
              st.integers(0, 21)),
)


def _random_run(P, ops, n_pages):
    # a shared prefix family: ids are prefixes of one of four histories
    hist = [_ids(20, seed=200 + k) for k in range(4)]
    hist[1][:8] = hist[0][:8]       # two histories share two pages
    t = Trace(P.KVPagePool(n_pages=n_pages, page_tokens=4))
    for op in ops:
        if op[0] == "put":
            _, sid, n, h, paged = op
            ids = hist[h][:n]
            t("put", sid, n, _kv_leaves(ids), ids=ids if paged else None)
        elif op[0] == "match_prefix":
            _, sid, n, h, align = op
            t("match_prefix", sid, hist[h][:n], align_tokens=align)
        elif op[0] == "truncate":
            t("truncate", op[1], op[2],
              others={1: np.array([op[2]], np.int32)})
        else:
            t(op[0], op[1])
    return t.out


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(OPS, min_size=1, max_size=25),
       n_pages=st.integers(2, 12))
def test_random_op_sequences_match_jax_pool(ops, n_pages):
    _same(_random_run(tkv, ops, n_pages), _random_run(jkv, ops, n_pages))
