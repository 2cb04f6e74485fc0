"""The port's decode engine (deeplearning4j_tpu_torch/serving/decode.py)
against the JAX package's, on the CPU, on a gpt_mini transplanted through
the zip (tests/test_transformer.py's size: V = 23, width 32, 2 blocks,
4 heads, max_len 48, seed 7, F32).

- The scenarios of tests/test_transformer.py's ``TestDecodeEngine``,
  ``TestChunkedPrefillSharing`` and ``TestSpeculativeDecode`` run on both
  engines: the generated tokens must be equal, and so must the counters
  and the pool's ``describe()`` (all but the timing-dependent
  ``interleaved_prefills`` and the inter-token histogram). The JAX side
  runs once per module (its engine compiles each bucket shape).
- Tokens are argmaxes of logits that the two packages compute in
  different f32 orders, so every emitted position must have a top-2
  margin above ``MARGIN``: a near-tie fails loudly instead of flipping a
  token.
- Within the port the engine's logits equal the sequential
  ``rnn_time_step`` reference bit for bit: alone, coalesced into buckets
  by concurrent sessions, after evictions, and under speculation.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu.serving import decode as jdecode
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.serving import decode as tdecode
from deeplearning4j_tpu_torch.serving.metrics import ServingStats
from deeplearning4j_tpu_torch.utils import serialization as tser

V = 23
# the smallest top-2 gap of the probabilities at an emitted position; the
# packages' logits differ by ~1e-7 (f32 sums in other orders)
MARGIN = 1e-4
SIZE = dict(vocab_size=V, width=32, n_layers=2, n_heads=4, seed=7)
COUNTERS = ("prefills", "decode_steps", "reprefills", "prefill_chunks",
            "chunked_prefills", "prefix_hits", "shared_tokens",
            "spec_rounds", "spec_proposed", "spec_accepted",
            "spec_rejected")
DESCRIBE = ("n_pages", "page_tokens", "pages_used", "sessions", "evictions",
            "prefix_sharing", "shared_pages", "store_pages",
            "logical_pages", "dedup_ratio", "page_hits", "prefix_matches",
            "truncations", "truncated_pages", "affinity_hits",
            "affinity_misses", "sessions_live", "prefill_chunk_tokens",
            "speculative_k", "spec_accept_tokens_per_step",
            "spec_draft_truncations")


def _ids(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).integers(0, V, n)]


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[np.asarray(ids)]


class Pkg:
    """One package's side: its engine module and its nets (the port's
    transplanted from the JAX package's). ``draft()`` is a second net
    object with the same weights, as the JAX tests build their drafts."""

    def __init__(self, name, mod, nets, draft):
        self.name, self.mod, self._nets, self._draft = name, mod, nets, draft

    def net(self, max_len=48):
        return self._nets[max_len]

    def draft(self):
        return self._draft

    def engine(self, **kw):
        kw.setdefault("replicas", 1)
        kw.setdefault("batch_window_ms", 1.0)
        return self.mod.DecodeEngine(self.net(), **kw)


def _summary(eng):
    d = eng.describe()
    return ({k: getattr(eng, k) for k in COUNTERS},
            {k: d[k] for k in DESCRIBE})


# ---- tests/test_transformer.py's scenarios, on either package
def generate_sequential(P):
    prompts = {f"s{i}": _ids(t, seed=20 + i)
               for i, t in enumerate([5, 9, 13, 17])}
    eng = P.engine()
    try:
        return {s: eng.generate(s, p, 6) for s, p in prompts.items()}, \
            _summary(eng)
    finally:
        eng.stop()


def _interleaved(eng, prompts, n):
    streams = {sid: [] for sid in prompts}
    logits = {sid: eng.prefill(sid, ids) for sid, ids in prompts.items()}
    for _ in range(n):
        for sid in prompts:
            tok = int(np.argmax(logits[sid]))
            streams[sid].append(tok)
            logits[sid] = eng.step(sid, tok)
    return streams


def eviction_recovers(P):
    prompts = {f"e{i}": _ids(t, seed=30 + i)
               for i, t in enumerate([6, 9, 12])}
    eng = P.engine(n_pages=4, page_tokens=4)
    try:
        return _interleaved(eng, prompts, 3), _summary(eng)
    finally:
        eng.stop()


def affinity_and_close(P):
    eng = P.engine(replicas=2)
    try:
        toks = [eng.generate("a", _ids(6, seed=40), 4),
                eng.generate("b", _ids(7, seed=41), 4)]
        closed = [eng.close_session("a"), eng.close_session("a")]
        return toks, closed, eng.sessions, _summary(eng)
    finally:
        eng.stop()


def _shared_prompts(n_prefix=16):
    prefix = _ids(n_prefix, seed=80)
    return {f"c{i}": prefix + _ids(t, seed=81 + i)
            for i, t in enumerate([5, 9, 3])}


def chunked_and_shared(P):
    eng = P.engine(prefix_sharing=True, prefill_chunk_pages=1)
    try:
        return {s: eng.generate(s, p, 4)
                for s, p in _shared_prompts().items()}, _summary(eng)
    finally:
        eng.stop()


def kill_switches(P):
    eng = P.engine(prefix_sharing=False, prefill_chunk_pages=0)
    try:
        return {s: eng.generate(s, p, 2)
                for s, p in _shared_prompts().items()}, _summary(eng)
    finally:
        eng.stop()


def shared_session_evicted(P):
    prefix = _ids(8, seed=90)
    prompts = {f"v{i}": prefix + _ids(t, seed=91 + i)
               for i, t in enumerate([2, 4])}
    eng = P.engine(n_pages=4, page_tokens=4)
    try:
        return _interleaved(eng, prompts, 3), _summary(eng)
    finally:
        eng.stop()


def speculative_all_accepted(P):
    eng = P.engine(speculative=3, draft_net=P.draft())
    try:
        return {f"g{i}": eng.generate(f"g{i}", _ids(t, seed=100 + i), 8)
                for i, t in enumerate([5, 9])}, _summary(eng)
    finally:
        eng.stop()


def speculative_all_rejected(P):
    prompt = _ids(6, seed=110)
    eng = P.engine(speculative=3, draft_net=P.draft())
    try:
        plain = P.engine()
        refs = plain.generate("r", prompt, 6)
        plain.stop()

        def wrong(sid, want, k, trace_id=None):
            idx = len(want) - len(prompt)
            good = refs[idx] if idx < len(refs) else 0
            return [(good + 1) % V] * k

        eng._propose = wrong
        return eng.generate("r", prompt, 6), _summary(eng)
    finally:
        eng.stop()


def speculative_evictions(P):
    prompts = {f"p{i}": _ids(t, seed=120 + i)
               for i, t in enumerate([6, 9, 12])}
    eng = P.engine(n_pages=6, page_tokens=4, speculative=2,
                   draft_net=P.draft())
    try:
        streams, errs = {}, []

        def run(sid):
            try:
                streams[sid] = eng.generate(sid, prompts[sid], 6)
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(f"{sid}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(s,), daemon=True) for s in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs, errs
        # how often the pool evicts depends on the threads' interleaving
        return streams, eng.pool.evictions > 0 and eng.reprefills > 0
    finally:
        eng.stop()


SCENARIOS = [generate_sequential, eviction_recovers, affinity_and_close,
             chunked_and_shared, kill_switches, shared_session_evicted,
             speculative_all_accepted, speculative_all_rejected,
             speculative_evictions]


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    """Both packages' nets; the port's are the JAX package's weights,
    carried through the zip."""
    jnets, tnets = {}, {}
    root = tmp_path_factory.mktemp("decode")
    for max_len in (48, 16):
        jnet = jzoo.gpt_mini(max_len=max_len, dtype=jzoo.F32, **SIZE)
        path = root / f"g{max_len}.zip"
        jser.write_model(jnet, str(path))
        jnets[max_len] = jnet
        tnets[max_len] = tser.restore_multi_layer_network(str(path),
                                                          device="cpu")
    return (Pkg("jax", jdecode, jnets,
                jzoo.gpt_mini(max_len=48, dtype=jzoo.F32, **SIZE)),
            Pkg("torch", tdecode, tnets,
                tser.restore_multi_layer_network(str(root / "g48.zip"),
                                                 device="cpu")))


@pytest.fixture(scope="module")
def jax_runs(pkgs):
    """Every scenario on the JAX engine, once."""
    return {f.__name__: f(pkgs[0]) for f in SCENARIOS}


def _reference(net, ids, n):
    """Sequential greedy through the port's rnn_time_step: (tokens, the
    logits row before each token)."""
    net.rnn_clear_previous_state()
    try:
        logits = net.rnn_time_step(_onehot(ids)[None]).float().numpy()[0, -1]
        toks, rows = [], []
        for _ in range(n):
            rows.append(logits)
            toks.append(int(np.argmax(logits)))
            logits = net.rnn_time_step(_onehot([toks[-1]])).float().numpy()[0]
        return toks, rows
    finally:
        net.rnn_clear_previous_state()


def _margin(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax_engine(pkgs, jax_runs, scenario):
    got = scenario(pkgs[1])
    assert got == jax_runs[scenario.__name__]


@pytest.mark.parametrize("prompt_seed,t", [(20, 5), (21, 9), (22, 13),
                                           (23, 17), (100, 5), (101, 9),
                                           (110, 6), (120, 6), (121, 9),
                                           (122, 12)])
def test_emitted_positions_have_a_clear_argmax(pkgs, prompt_seed, t):
    """The scenarios' streams (prompts by seed and length) have a top-2
    margin above MARGIN at every emitted position."""
    _, rows = _reference(pkgs[1].net(), _ids(t, seed=prompt_seed), 8)
    margins = [_margin(r) for r in rows]
    assert min(margins) > MARGIN, margins


def test_shared_prompt_streams_have_a_clear_argmax(pkgs):
    for ids in list(_shared_prompts().values()) + [
            _ids(6, seed=30), _ids(9, seed=31), _ids(12, seed=32),
            _ids(6, seed=40), _ids(7, seed=41),
            _ids(8, seed=90) + _ids(2, seed=91),
            _ids(8, seed=90) + _ids(4, seed=92)]:
        _, rows = _reference(pkgs[1].net(), ids, 4)
        assert min(_margin(r) for r in rows) > MARGIN


def test_engine_logits_equal_sequential_reference_bit_for_bit(pkgs):
    """Four sessions stepped from threads coalesce into bucket forwards
    of other row counts, over a pool small enough to evict; every logits
    row the engine returns equals the sequential reference's. The threads
    meet at a barrier after their prefills and before each step: the
    four prompts take 11 pages of the pool's 6, so a session still open
    has been evicted by its first step and re-prefills, and the steps
    are issued together, within the batch window."""
    net = pkgs[1].net()
    prompts = {f"b{i}": _ids(t, seed=140 + i)
               for i, t in enumerate([3, 8, 11, 17])}
    refs = {s: _reference(net, p, 5) for s, p in prompts.items()}
    stats = ServingStats()
    eng = tdecode.DecodeEngine(net, replicas=1, batch_window_ms=20.0,
                               n_pages=6, page_tokens=4, stats=stats)
    errs = []
    barrier = threading.Barrier(len(prompts))
    try:
        def run(sid):
            try:
                toks, rows = refs[sid]
                got = eng.prefill(sid, prompts[sid])
                for tok, row in zip(toks, rows):
                    assert np.array_equal(got, row), sid
                    barrier.wait(timeout=120)
                    got = eng.step(sid, tok)
            except Exception as e:  # noqa: BLE001 — asserted below
                barrier.abort()
                errs.append(f"{sid}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(s,), daemon=True) for s in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        eng.stop()
    assert not errs, errs
    assert stats.batch_rows > stats.batches   # some forwards coalesced
    assert eng.pool.evictions > 0 and eng.reprefills > 0


def test_speculative_stream_equals_plain_stream(pkgs):
    """A draft of other weights (the port's gpt_mini_draft) proposes;
    the stream is the plain greedy stream, and some proposals are
    rejected, so the rollback path runs."""
    net = pkgs[1].net()
    draft = tzoo.gpt_mini_draft(vocab_size=V, width=16, n_layers=1,
                                n_heads=2, max_len=48, seed=3,
                                dtype=tzoo.F32, device="cpu")
    prompt = _ids(7, seed=150)
    eng = tdecode.DecodeEngine(net, batch_window_ms=1.0, speculative=3,
                               draft_net=draft)
    try:
        got = eng.generate("s", prompt, 10)
    finally:
        eng.stop()
    assert got == _reference(net, prompt, 10)[0]
    assert eng.spec_rounds > 0 and eng.spec_rejected > 0


def test_prompt_beyond_cache_extent_and_overflow_release(pkgs):
    net = pkgs[1].net(16)
    eng = tdecode.DecodeEngine(net, replicas=1, batch_window_ms=1.0)
    try:
        assert eng.max_prompt == 16
        with pytest.raises(ValueError):
            eng.prefill("big", _ids(17, seed=50))
        eng.prefill("edge", _ids(16, seed=51))
        assert eng.pool.pages_used > 0
        with pytest.raises(ValueError):
            eng.step("edge", 1)
        assert eng.pool.pages_used == 0
        assert eng.close_session("edge") is True
        with pytest.raises(KeyError):
            eng.step("nobody", 1)
    finally:
        eng.stop()


def test_speculative_errors_match_jax(pkgs):
    net = pkgs[1].net()
    bad = tzoo.gpt_mini_draft(vocab_size=V + 1, width=16, n_layers=1,
                              n_heads=2, max_len=48, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tdecode.DecodeEngine(net, speculative=2, draft_net=bad)
    short = tzoo.gpt_mini_draft(vocab_size=V, width=16, n_layers=1,
                                n_heads=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="extent"):
        tdecode.DecodeEngine(net, speculative=2, draft_net=short)
    with pytest.raises(ValueError, match="draft_net"):
        tdecode.DecodeEngine(net, speculative=2)
    # the scheduler is ported: the engine hands it to its replica set
    from deeplearning4j_tpu_torch.scheduling import SchedulingCore
    core = SchedulingCore()
    eng = tdecode.DecodeEngine(net, scheduler=core)
    try:
        assert eng.scheduler is core and eng.fleet.scheduler is core
    finally:
        eng.stop()


def test_env_knobs(pkgs, monkeypatch):
    net = pkgs[1].net()
    prompt = _ids(7, seed=130)
    want = _reference(net, prompt, 5)[0]
    monkeypatch.setenv("DL4J_TPU_SPECULATIVE_K", "0")
    eng = tdecode.DecodeEngine(net, batch_window_ms=1.0, draft_net=net)
    try:
        assert eng.spec_k == 0 and eng._draft is None
        assert eng.generate("k", prompt, 5) == want
        assert eng.describe()["spec_accept_tokens_per_step"] is None
    finally:
        eng.stop()
    monkeypatch.setenv("DL4J_TPU_SPECULATIVE_K", "2")
    monkeypatch.setenv("DL4J_TPU_PREFILL_CHUNK_PAGES", "0")
    monkeypatch.setenv("DL4J_TPU_KV_PREFIX_SHARING", "0")
    eng = tdecode.DecodeEngine(net, batch_window_ms=1.0, draft_net=net)
    try:
        assert eng.spec_k == 2 and eng.generate("e", prompt, 5) == want
        d = eng.describe()
        assert d["prefill_chunk_tokens"] == 0 and d["prefix_sharing"] is False
        assert eng.spec_rounds > 0
    finally:
        eng.stop()


def test_warm_runs_every_ladder(pkgs):
    eng = tdecode.DecodeEngine(pkgs[1].net(), batch_window_ms=1.0,
                               max_batch=4, speculative=2,
                               draft_net=pkgs[1].net())
    try:
        assert eng.warm() == [2, 4]
        prompt = _ids(9, seed=160)
        assert eng.generate("w", prompt, 4) == \
            _reference(pkgs[1].net(), prompt, 4)[0]
    finally:
        eng.stop()


# the char-RNN's engine logits against its sequential reference: the
# LSTM's input product is a GEMM whose rows (bucket rows x padded steps)
# change with the bucket, so it is not decode-stable the way the
# transformer's streaming path is; f32 sums in other orders (F32), and
# tests/test_torch_char_rnn.py's BF16_PROB_TOL (BF16)
LSTM_TOL = {"F32": 1e-5, "BF16": 2e-3}


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_lstm_carries_decode_unpaged(policy):
    """A char-RNN's h/c carries have no token axis: the engine decodes it
    unpaged (no chunking, sharing or speculation); under BF16 its carries
    travel as bf16 bits. Fed the sequential rnn_time_step reference's
    tokens, its logits lie within LSTM_TOL of the reference's."""
    net = tzoo.char_rnn(vocab_size=V, hidden=16, n_layers=2, seed=3,
                        dtype=getattr(tzoo, policy), device="cpu")
    eng = tdecode.DecodeEngine(net, batch_window_ms=1.0, speculative=2,
                               draft_net=net)
    try:
        d = eng.describe()
        assert d["prefill_chunk_tokens"] == 0 and not d["prefix_sharing"]
        assert eng.spec_k == 0
        for sid, (t, seed) in enumerate([(6, 170), (9, 171)]):
            prompt = _ids(t, seed=seed)
            toks, rows = _reference(net, prompt, 5)
            got = [eng.prefill(sid, prompt)]
            for tok in toks[:-1]:
                got.append(eng.step(sid, tok))
            np.testing.assert_allclose(np.stack(got), np.stack(rows),
                                       atol=LSTM_TOL[policy], rtol=0)
    finally:
        eng.stop()
