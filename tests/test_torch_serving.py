"""The torch port's serving path against the JAX package.

* allocator and scheduler: the JAX package's cases, run against the
  port's own copies;
* engine: on a JAX-initialised TINY_CONFIG GPT converted by the bridge,
  the port's ``ServingEngine(device="cpu")`` on both attention paths must
  give the JAX engine's token streams and the full-forward greedy golden
  token for token, and its prefill logits must match JAX's at 1e-4.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import attention
from paddle_operator_tpu_torch.serving import (
    SHED_POLICIES, ContinuousBatcher, KvBlockAllocator, KvCacheFull,
    PagedKvCache, Request, RequestQueue, ServingEngine)


# ---------------------------------------------------------------------------
# KV block allocator: conservation, fragmentation, all-or-nothing
# ---------------------------------------------------------------------------

def test_allocator_alloc_free_conserves_blocks():
    a = KvBlockAllocator(8, 4)
    t1 = a.alloc_sequence("a", 10)      # 3 blocks
    t2 = a.alloc_sequence("b", 4)       # 1 block
    assert len(t1) == 3 and len(t2) == 1
    assert not set(t1) & set(t2)
    assert a.check() == []
    st = a.stats()
    assert st["blocks_used"] == 4 and st["blocks_free"] == 4
    assert st["waste_slots"] == 2       # ceil(10/4)*4 - 10 tail slack
    a.free_sequence("a")
    a.free_sequence("b")
    assert a.check() == []
    assert a.stats()["blocks_used"] == 0
    assert a.stats()["blocks_peak"] == 4


def test_allocator_exhaustion_is_all_or_nothing():
    a = KvBlockAllocator(4, 4)
    a.alloc_sequence("a", 12)           # 3 of 4 blocks
    with pytest.raises(KvCacheFull):
        a.alloc_sequence("b", 8)        # needs 2, only 1 free
    assert a.sequences() == ["a"]
    assert a.check() == []
    a.alloc_sequence("c", 4)
    assert a.stats()["blocks_free"] == 0


def test_allocator_reservation_advance_and_exhaustion():
    a = KvBlockAllocator(8, 4)
    a.alloc_sequence("s", 8, live_tokens=3)   # prompt 3, budget 8
    assert a.seq_len("s") == 3
    assert a.stats()["reserved_slack"] == 5
    for want in (3, 4, 5, 6, 7):
        assert a.advance("s") == want
    with pytest.raises(KvCacheFull):
        a.advance("s")
    assert a.check() == []


def test_allocator_append_token_grows_at_block_boundary():
    a = KvBlockAllocator(4, 4)
    a.alloc_sequence("s", 4)
    assert a.append_token("s") is not None      # 5th token: new block
    assert a.append_token("s") is None          # 6th: inside it
    assert len(a.block_table("s")) == 2
    assert a.seq_len("s") == 6
    assert a.check() == []


@pytest.mark.parametrize("call", [
    lambda a: a.alloc_sequence("s", 4),                   # double alloc
    lambda a: a.alloc_sequence("t", 0),                   # empty
    lambda a: a.alloc_sequence("t", 4, live_tokens=5),    # live > reserved
])
def test_allocator_rejects_bad_allocations(call):
    a = KvBlockAllocator(8, 4)
    assert a.free_sequence("ghost") == 0        # unknown free is a no-op
    a.alloc_sequence("s", 4)
    with pytest.raises(ValueError):
        call(a)
    assert a.check() == []


def test_paged_cache_writes_in_place_at_table_slots():
    c = PagedKvCache(num_blocks=6, block_size=4, layers=2, heads=2,
                     head_dim=8, device="cpu")
    assert c.dummy_page == 6 and c.k_pages[0].shape == (7, 4, 2, 8)
    storage = c.k_pages[1].data_ptr()
    c.allocator.alloc_sequence("s", 6)
    table = c.allocator.block_table("s")
    k = torch.arange(6 * 2 * 8, dtype=torch.float32).reshape(6, 2, 8)
    c.write_prefill("s", 1, k, -k)
    assert c.k_pages[1].data_ptr() == storage
    assert torch.equal(c.k_pages[1][table[0]], k[:4])
    assert torch.equal(c.k_pages[1][table[1], :2], k[4:])
    assert torch.equal(c.v_pages[1][table[1], :2], -k[4:])
    assert c.k_pages[0].abs().sum() == 0        # other layers untouched
    assert c.k_pages[1][c.dummy_page].abs().sum() == 0


def test_paged_cache_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PagedKvCache(num_blocks=6, block_size=4, layers=2, heads=2,
                     head_dim=8)


# ---------------------------------------------------------------------------
# request queue: bounded admission, counted sheds
# ---------------------------------------------------------------------------

def _req(i, prompt_len=4, budget=4):
    return Request("r%03d" % i, prompt=[1] * prompt_len,
                   max_new_tokens=budget)


def test_queue_fifo_and_reject_new_shed_is_counted():
    q = RequestQueue(2, clock=lambda: 0.0)
    assert q.submit(_req(0)) == (True, None)
    assert q.submit(_req(1)) == (True, None)
    accepted, shed = q.submit(_req(2))
    assert accepted is False and shed is None
    c = q.counts()
    assert c["submitted"] == 3 and c["shed_reject_new"] == 1
    assert q.pop().request_id == "r000"
    assert q.pop().request_id == "r001"
    assert q.pop() is None
    assert q.counts()["admitted"] == 2


def test_queue_drop_oldest_sheds_the_stalest():
    q = RequestQueue(2, shed_policy="drop_oldest", clock=lambda: 0.0)
    q.submit(_req(0))
    q.submit(_req(1))
    accepted, shed = q.submit(_req(2))
    assert accepted is True and shed.request_id == "r000"
    assert q.counts()["shed_drop_oldest"] == 1
    assert [q.pop().request_id, q.pop().request_id] == ["r001", "r002"]


def test_queue_requeue_front_preserves_order_and_returns_overflow():
    q = RequestQueue(3)
    q.submit(_req(5))
    overflow = q.requeue_front([_req(0), _req(1), _req(2)])
    assert [r.request_id for r in overflow] == ["r000"]
    assert [q.pop().request_id for _ in range(3)] == \
        ["r001", "r002", "r005"]


@pytest.mark.parametrize("capacity,policy", [(0, "reject_new"),
                                             (4, "coin_flip")])
def test_queue_rejects_bad_config(capacity, policy):
    assert SHED_POLICIES == ("reject_new", "drop_oldest")
    with pytest.raises(ValueError):
        RequestQueue(capacity, shed_policy=policy)


# ---------------------------------------------------------------------------
# continuous batcher: iteration-level scheduling
# ---------------------------------------------------------------------------

def _batcher(capacity=8, max_batch=2, t=None, **kw):
    t = t if t is not None else [0.0]
    clock = lambda: t[0]  # noqa: E731
    q = RequestQueue(capacity, clock=clock)
    return q, ContinuousBatcher(q, max_batch, clock=clock, **kw), t


def _step(active):
    """Engine-step fake: every sequence emits token 7, finishing after its
    budget (the batcher enforces max_new_tokens)."""
    return [(7, False)] * len(active)


class _Metrics:
    """The batcher's optional metrics hook, recorded."""

    def __init__(self):
        self.seen = []

    def observe_request(self, req, outcome):
        self.seen.append((req.request_id, outcome, len(req.generated),
                          req.ttft(), req.tpot()))


def test_batcher_admits_fifo_up_to_max_batch():
    q, b, _ = _batcher(max_batch=2)
    for i in range(4):
        q.submit(_req(i, budget=2))
    b.step(_step)
    assert b.active_ids() == ["r000", "r001"]
    b.step(_step)                               # budget 2 -> both finish
    assert b.counts()["completed"] == 2
    b.step(_step)                               # freed slots refill FIFO
    assert b.active_ids() == ["r002", "r003"]


def test_batcher_defers_admission_when_kv_pool_full():
    admitted = []
    q, b, _ = _batcher(max_batch=4,
                       on_admit=lambda r: len(admitted) < 1
                       and not admitted.append(r.request_id))
    for i in range(2):
        q.submit(_req(i, budget=1))
    b.step(_step)
    assert admitted == ["r000"]
    assert q.depth() == 1
    assert b.counts()["admit_deferred"] == 1
    assert q.pop().request_id == "r001"


def test_batcher_completion_flows_into_metrics_and_retire():
    retired = []
    m = _Metrics()
    q, b, t = _batcher(max_batch=2, metrics=m,
                       on_retire=lambda r: retired.append(r.request_id))
    q.submit(_req(0, budget=3))
    for _ in range(3):
        t[0] += 0.5
        b.step(_step)
    assert retired == ["r000"]
    assert m.seen == [("r000", "ok", 3, 0.5, 0.5)]


def test_batcher_preempt_returns_victims_reset():
    q, b, _ = _batcher(max_batch=2)
    q.submit(_req(0, budget=8))
    b.step(_step)
    victims = b.preempt()
    assert [v.request_id for v in victims] == ["r000"]
    assert victims[0].generated == [] and victims[0].t_admitted == 0.0
    assert b.in_flight() == 0
    assert b.counts()["preempted"] == 1


def test_batcher_drain_runs_to_empty_without_admitting():
    q, b, _ = _batcher(max_batch=2)
    for i in range(3):
        q.submit(_req(i, budget=2))
    b.step(_step)
    assert b.drain(_step) == 1
    assert b.in_flight() == 0
    assert q.depth() == 1
    assert b.max_batch == 2


def test_batcher_rejects_misaligned_engine_step():
    q, b, _ = _batcher()
    q.submit(_req(0))
    with pytest.raises(RuntimeError):
        b.step(lambda active: [])


def test_batcher_admit_hook_raise_conserves_the_popped_request():
    m = _Metrics()

    def exploding_admit(req):
        raise RuntimeError("kv accounting broke mid-admit")

    q, b, _ = _batcher(metrics=m, on_admit=exploding_admit)
    q.submit(_req(0))
    with pytest.raises(RuntimeError):
        b.step(_step)
    assert b.counts()["admit_error"] == 1
    assert [s[:2] for s in m.seen] == [("r000", "error")]
    assert b.counts()["completed"] == 0 and q.depth() == 0


# ---------------------------------------------------------------------------
# engine: device choice, admission, and the goldens against JAX
# ---------------------------------------------------------------------------

def _port_tiny_params():
    return tgpt.init(torch.Generator().manual_seed(0), tgpt.TINY_CONFIG)


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(_port_tiny_params(), tgpt.TINY_CONFIG)
    with pytest.raises(RuntimeError):
        ServingEngine(_port_tiny_params(), tgpt.TINY_CONFIG, device="cuda")


def test_engine_admit_validates_prompt_before_reserving_kv():
    eng = ServingEngine(_port_tiny_params(), tgpt.TINY_CONFIG, max_batch=2,
                        prompt_pad=8, num_blocks=16, block_size=4,
                        attn="reference", device="cpu")
    for bad_prompt in ([], [1] * 9):
        with pytest.raises(ValueError):
            eng.admit(Request("bad", prompt=bad_prompt, max_new_tokens=2))
    with pytest.raises(ValueError):            # beyond max_seq
        eng.admit(Request("long", prompt=[1], max_new_tokens=256))
    assert eng.cache.allocator.stats()["blocks_used"] == 0
    ok = Request("ok", prompt=[1, 2, 3], max_new_tokens=2)
    assert eng.admit(ok)
    assert eng.cache.allocator.stats()["blocks_used"] > 0
    eng.retire(ok)
    assert eng.cache.allocator.stats()["blocks_used"] == 0
    with pytest.raises(ValueError):
        ServingEngine(_port_tiny_params(), tgpt.TINY_CONFIG, attn="flash",
                      device="cpu")


PROMPTS = [[5, 99, 7], [11, 3, 250, 42, 8], [1023]]
BUDGETS = [4, 3, 5]


def _serve(engine_cls, params, cfg, attn, **kw):
    eng = engine_cls(params, cfg, max_batch=4, prompt_pad=16, num_blocks=64,
                     block_size=8, attn=attn, **kw)
    serving = _serving_module(engine_cls)
    reqs = [serving.Request("g%d" % i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS))]
    q = serving.RequestQueue(capacity=8)
    batcher = serving.ContinuousBatcher(q, max_batch=4, on_admit=eng.admit,
                                        on_retire=eng.retire)
    for r in reqs:
        q.submit(r)
    for _ in range(32):
        if batcher.step(eng.step_fn) == 0 and q.depth() == 0:
            break
    assert eng.cache.allocator.check() == []
    assert eng.cache.allocator.stats()["blocks_used"] == 0
    return [r.generated for r in reqs]


def _serving_module(engine_cls):
    """The scheduler that goes with an engine: the port's, or the JAX
    package's for its own engine."""
    if engine_cls is ServingEngine:
        from paddle_operator_tpu_torch import serving
    else:
        from paddle_operator_tpu import serving
    return serving


@pytest.fixture(scope="module")
def jax_golden():
    """A JAX-initialised TINY_CONFIG tree (numpy), the JAX engine's token
    streams on the reference path, and the full-forward greedy golden.

    The golden is taken from ONE causal full forward over each prompt
    followed by the JAX engine's stream: a stream is the greedy generation
    exactly when every generated token is the argmax of the logits at the
    position before it (causality makes those logits the prefix's own).
    """
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_operator_tpu.models import gpt
    from paddle_operator_tpu.serving import engine as jengine

    cfg = dict(gpt.TINY_CONFIG)
    params = gpt.init(jax.random.PRNGKey(0), cfg)
    streams = _serve(jengine.ServingEngine, params, cfg, "reference",
                     label="test-torch-port")
    full = [list(p) + s for p, s in zip(PROMPTS, streams)]
    ids = np.zeros((len(full), max(map(len, full))), np.int32)
    for i, seq in enumerate(full):
        ids[i, :len(seq)] = seq          # trailing pad cannot reach back
    forward = jax.jit(lambda p, x: gpt.apply(p, x, dtype=jnp.float32,
                                             attn_impl="einsum")[0])
    logits = np.asarray(forward(params, jnp.asarray(ids)))
    golden, prefill = [], []
    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        rows = logits[i, len(p) - 1:len(p) - 1 + n]
        golden.append([int(t) for t in rows.argmax(-1)])
        prefill.append(rows[0])
    return {"tree": jax.tree_util.tree_map(np.asarray, params),
            "jax_streams": streams, "golden": golden,
            "prefill_logits": prefill}


@pytest.mark.parametrize("attn", ["paged", "reference"])
def test_engine_streams_match_jax_engine_and_full_forward(jax_golden, attn):
    assert jax_golden["jax_streams"] == jax_golden["golden"]
    params = bridge.params_from_numpy(jax_golden["tree"], device="cpu")
    before = attention.paged_decode_attention.launches
    got = _serve(ServingEngine, params, tgpt.TINY_CONFIG, attn,
                 device="cpu")
    assert got == jax_golden["golden"]
    # CPU tensors take the plain version: no kernel launch is counted
    assert attention.paged_decode_attention.launches == before


def test_engine_prefill_logits_match_jax(jax_golden):
    eng = ServingEngine(bridge.params_from_numpy(jax_golden["tree"],
                                                 device="cpu"),
                        tgpt.TINY_CONFIG, prompt_pad=16, device="cpu")
    for prompt, want in zip(PROMPTS, jax_golden["prefill_logits"]):
        ids = torch.zeros((1, 16), dtype=torch.long)
        ids[0, :len(prompt)] = torch.tensor(prompt)
        logits, ks, vs = eng.prefill_forward(ids, len(prompt))
        assert len(ks) == len(vs) == tgpt.TINY_CONFIG["layers"]
        assert tuple(ks[0].shape) == (16, 4, 32)
        assert np.max(np.abs(logits.numpy() - want)) < 1e-4
