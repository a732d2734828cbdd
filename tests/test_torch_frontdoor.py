"""The port's HTTP front door (``paddle_tpu_torch/serving/frontdoor.py``)
against the JAX package's, on the CPU, over real sockets on 127.0.0.1.

A port ``FrontDoor`` and a JAX ``FrontDoor``, each over a tiny engine of
its package built from the same weights, answer the same requests one at
a time: unary completions and SSE streams give the same token ids (and
the same documents), a stream's tokens equal the unary answer; 401 on an
unknown bearer key, 429 when a tenant's token bucket runs dry (the
count the bucket arithmetic predicts), 400 on an unknown lane, 503 with
the scheduler's ``queue_depth``/``est_wait_s`` on a full queue, all with
the same bodies; ``/v1/models`` and ``/metrics`` on the same port; the
lane and the tenant reach the engine. Exact; no tolerance.
"""
import dataclasses
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import frontdoor as jfront
from paddle_tpu.serving.scheduler import QueueFullError as JaxQueueFull
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.framework import metrics
from paddle_tpu_torch.models import GPTConfig
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.serving import frontdoor as tfront
from paddle_tpu_torch.serving.scheduler import QueueFullError

VOCAB = 96
LIMITS = {"starved": (0.01, 12.0)}     # refill: 12 tokens in 20 minutes
KEYS = {"k-acme": "acme"}


@pytest.fixture(scope="module")
def doors():
    """(port base URL, JAX base URL, port door, port engine) over tiny
    engines of the same weights."""
    paddle.seed(21)
    jcfg = JaxGPTConfig(vocab_size=VOCAB, hidden_size=64,
                        num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64,
                        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        initializer_range=0.5)
    jmodel = JaxGPT(jcfg)
    jmodel.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(jmodel).items()}
    tmodel = gpt_from_jax_params(
        params, GPTConfig(**dataclasses.asdict(jcfg)), device="cpu")
    kw = dict(num_slots=2, max_len=64, min_bucket=8)
    teng = GenerationEngine(tmodel, device="cpu", **kw)
    jeng = JaxEngine(jmodel, **kw)
    tdoor = tfront.FrontDoor(teng, tenant_limits=LIMITS, api_keys=KEYS)
    jdoor = jfront.FrontDoor(jeng, tenant_limits=LIMITS, api_keys=KEYS)
    try:
        tsrv, jsrv = tdoor.start(), jdoor.start()
        assert tsrv.url.startswith("http://127.0.0.1:")
        yield tsrv.url, jsrv.url, tdoor, teng
    finally:
        tdoor.close()
        jdoor.close()
        teng.close()
        jeng.close()


def _post(url, doc, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _sse(url, doc):
    req = urllib.request.Request(
        url, data=json.dumps(dict(doc, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        frames = r.read().decode().strip().split("\n\n")
    assert all(f.startswith("data: ") for f in frames)
    payloads = [f[len("data: "):] for f in frames]
    assert payloads[-1] == "[DONE]"
    chunks = [json.loads(p) for p in payloads[:-1]]
    return [c["choices"][0]["token_id"] for c in chunks[:-1]], chunks[-1]


def _both(doors, path, doc, headers=None):
    turl, jurl = doors[0], doors[1]
    return (_post(turl + path, doc, headers),
            _post(jurl + path, doc, headers))


def _strip_id(doc):
    return {k: v for k, v in doc.items() if k != "id"}


PROMPTS = [[5, 6, 7], [3] * 11, list(range(10, 30)), [44]]


def test_unary_and_sse_tokens_match_jax(doors):
    turl, jurl = doors[0], doors[1]
    for i, prompt in enumerate(PROMPTS):
        body = {"prompt": prompt, "max_tokens": 4 + i}
        (ts, tdoc, _), (js, jdoc, _) = _both(doors, "/v1/completions", body)
        assert ts == js == 200
        assert _strip_id(tdoc) == _strip_id(jdoc), prompt
        ttoks, tfinal = _sse(turl + "/v1/completions", body)
        jtoks, jfinal = _sse(jurl + "/v1/completions", body)
        assert ttoks == jtoks == tdoc["choices"][0]["token_ids"]
        assert _strip_id(tfinal) == _strip_id(jfinal)
        assert tfinal["choices"][0]["finish_reason"] == "length"


def test_unknown_api_key_401(doors):
    (ts, tdoc, _), (js, jdoc, _) = _both(
        doors, "/v1/completions", {"prompt": [1], "max_tokens": 1},
        {"Authorization": "Bearer nope"})
    assert ts == js == 401 and tdoc == jdoc
    assert tdoc["error"]["type"] == "invalid_api_key"


def test_bad_lane_400(doors):
    (ts, tdoc, _), (js, jdoc, _) = _both(
        doors, "/v1/completions", {"prompt": [1], "lane": "vip"})
    assert ts == js == 400 and tdoc == jdoc
    assert tfront.LANES == jfront.LANES == ("interactive", "batch")


def test_token_bucket_sheds_as_its_arithmetic_predicts(doors):
    """Burst 12 at 0.01 tokens/s: a 12-token request drains the bucket,
    and each following one in the test's seconds is shed."""
    before = doors[2].stats()["shed"].get("starved", 0)
    statuses = {"torch": [], "jax": []}
    for _ in range(3):
        (ts, tdoc, th), (js, jdoc, jh) = _both(
            doors, "/v1/completions", {"prompt": [1] * 3, "max_tokens": 9},
            {"X-Tenant": "starved"})
        statuses["torch"].append(ts)
        statuses["jax"].append(js)
        if ts == 429:
            assert js == 429
            assert tdoc["error"]["type"] == jdoc["error"]["type"] \
                == "rate_limit_exceeded"
            assert int(th["Retry-After"]) >= 1
    assert statuses["torch"] == statuses["jax"] == [200, 429, 429]
    assert doors[2].stats()["shed"]["starved"] - before == 2


def test_token_bucket_matches_jax_on_one_clock(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    buckets = [tfront.TokenBucket(5.0, 12.0), jfront.TokenBucket(5.0, 12.0)]
    for dt, cost in ((0, 12), (0, 1), (0.1, 1), (0.5, 3), (0, 30), (2, 8)):
        now[0] += dt
        got = [b.try_take(cost) for b in buckets]
        assert got[0] == got[1]
    with pytest.raises(ValueError):
        tfront.TokenBucket(0, 1)


class _FullEngine:
    def __init__(self, error):
        self.error = error

    def submit(self, *a, **k):
        raise self.error

    def stats(self):
        return {"queue_depth": 7, "active_requests": 0}


def test_queue_full_503_carries_the_scheduler_hints():
    docs = []
    for door_mod, err in ((tfront, QueueFullError), (jfront, JaxQueueFull)):
        d = door_mod.FrontDoor(_FullEngine(err(
            "admission queue is full", queue_depth=7, est_wait_s=2.5)))
        try:
            st, doc, hdrs = _post(d.start().url + "/v1/completions",
                                  {"prompt": [1]})
        finally:
            d.close()
        assert st == 503 and hdrs["Retry-After"] == "3"
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["error"]["queue_depth"] == 7
    assert docs[0]["error"]["est_wait_s"] == 2.5


def test_models_and_metrics_share_the_port(doors):
    turl, jurl = doors[0], doors[1]
    with urllib.request.urlopen(turl + "/v1/models", timeout=30) as r:
        tdoc = json.loads(r.read())
    with urllib.request.urlopen(jurl + "/v1/models", timeout=30) as r:
        jdoc = json.loads(r.read())
    assert [m["id"] for m in tdoc["data"]] == [m["id"] for m in jdoc["data"]]
    _post(turl + "/v1/completions", {"prompt": [2, 3], "max_tokens": 2})
    with urllib.request.urlopen(turl + "/metrics", timeout=30) as r:
        parsed = metrics.parse_prometheus(r.read().decode())
    eid = str(doors[3]._eid)
    assert any(name == "serving_requests_retired"
               and dict(labels).get("engine") == eid
               for name, labels in parsed["samples"])
    assert "serving_tenant_goodput_rps" in parsed["types"]


def test_lane_and_tenant_reach_the_engine(doors):
    turl, teng = doors[0], doors[3]
    st, doc, _ = _post(turl + "/v1/completions",
                       {"prompt": [9, 8], "max_tokens": 2},
                       {"Authorization": "Bearer k-acme", "X-Lane": "batch"})
    assert st == 200
    trace = teng.flight_recorder.tail_traces()["recent"][-1]
    assert (trace["tenant"], trace["lane"]) == ("acme", "batch")
    assert teng.stats()["tenants"]["acme"]["retired"] >= 1
