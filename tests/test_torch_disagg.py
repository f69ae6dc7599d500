"""The disaggregated KV handoff between the JAX package and the port, on the
CPU, in f32 on the tiny preset: a JAX prefill replica ships its pages to a
port decode replica over real HTTP and back; the decode replica's greedy
tokens equal the JAX reference engine's exactly; the wire payload is the
same bytes (bf16 through JAX's own dtype reader, the prefix-key digests);
the refusals (409 dense, 400 mismatch) and a dead decode URL degrade as in
JAX. Every HTTP wait is bounded by its timeout."""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tony_tpu.models import paged_cache as JPC  # noqa: E402
from tony_tpu.models import serving as JS  # noqa: E402
from tony_tpu.models import serving_http as JH  # noqa: E402
from tony_tpu.models.llama import LLAMA_TINY  # noqa: E402
from tony_tpu.models.llama import init as jax_init  # noqa: E402
from tony_tpu.serve import disagg as JD  # noqa: E402
from tony_tpu_torch.models import paged_cache as TPC  # noqa: E402
from tony_tpu_torch.models import serving as TS  # noqa: E402
from tony_tpu_torch.models import serving_http as TH  # noqa: E402
from tony_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from tony_tpu_torch.models.llama import config_from_dict  # noqa: E402
from tony_tpu_torch.serve import disagg as TD  # noqa: E402

CFG = dataclasses.replace(LLAMA_TINY, dtype="float32")
ENGINE = dict(num_slots=2, max_len=64, decode_chunk=4, kv="paged", page_len=8)
PROMPT = list(range(1, 25))  # 24 tokens: 3 full pages of 8
MAX_TOKENS = 6


@pytest.fixture(scope="module")
def params():
    jp = jax_init(jax.random.PRNGKey(0), CFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def reference(params):
    """The JAX engine's greedy tokens for PROMPT, with no handoff."""
    eng = JS.ContinuousBatcher(params[0], CFG, **ENGINE)
    rid = eng.submit(PROMPT, MAX_TOKENS)
    return eng.run()[rid]


def _serve(srv, handler_base, **attrs):
    handler = type("Handler", (handler_base,), {"server_ref": srv, **attrs})
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture()
def replicas(params):
    """start(side, role, **engine) → (EngineServer, url) for side "jax" or
    "torch", all on the same f32 weights; every server stops at teardown."""
    jp, tp = params
    made = []

    def start(side, role="serve", **kw):
        cfg = {**ENGINE, **kw}
        if side == "jax":
            srv = JH.EngineServer(JS.ContinuousBatcher(jp, CFG, **cfg), role=role).start()
            httpd, url = _serve(srv, JH._Handler, tokenizer=None)
        else:
            tcfg = config_from_dict({"preset": "tiny", "dtype": "float32"})
            srv = TH.EngineServer(TS.ContinuousBatcher(tp, tcfg, **cfg), role=role).start()
            httpd, url = _serve(srv, TH._Handler)
        made.append((srv, httpd))
        return srv, url

    yield start
    for srv, httpd in made:
        httpd.shutdown()
        httpd.server_close()
        srv.stop(timeout_s=10)


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.load(r)


@pytest.mark.parametrize("prefill_side,decode_side", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-to-port", "port-to-jax"])
def test_handoff_across_packages_then_greedy_tokens_equal_reference(
        replicas, reference, prefill_side, decode_side):
    pre, pre_url = replicas(prefill_side, role="prefill")
    dec, dec_url = replicas(decode_side)
    st, resp = _post(pre_url + "/v1/prefill", {"prompt_tokens": PROMPT, "decode_url": dec_url})
    assert st == 200 and "ship_error" not in resp, resp
    assert (resp["pages"], resp["adopted"], resp["already_resident"]) == (3, 3, 0)
    assert resp["first_token"] == reference[0] and resp["handoff_ms"] > 0
    assert pre.kv_handoff_exported == 3 and dec.kv_handoff_adopted == 3
    # the decode replica finds the adopted pages at admission: prefix hits,
    # and the same greedy tokens as the JAX engine that computed everything
    st, out = _post(dec_url + "/v1/completions", {"prompt_tokens": PROMPT, "max_tokens": MAX_TOKENS})
    assert st == 200 and out["tokens"] == reference
    stats = _stats(dec_url)
    assert stats["prefix_hit_tokens"] > 0 and stats["kv_handoff_adopted"] == 3
    assert stats["role"] == "serve" and _stats(pre_url)["role"] == "prefill"
    # a re-ship of resident pages adopts nothing
    st, again = _post(pre_url + "/v1/prefill", {"prompt_tokens": PROMPT, "decode_url": dec_url})
    assert st == 200 and (again["adopted"], again["already_resident"]) == (0, 3)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_bf16_payload_is_the_same_bits_in_both_packages(params, direction):
    """A bf16 pool's pages, exported by one package, decode in the other to
    the exported pool's bits: the port through an int16 view, JAX through
    its own ``_np_dtype`` (ml_dtypes)."""
    jp = jax_init(jax.random.PRNGKey(2), LLAMA_TINY)                    # bf16
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = config_from_dict({"preset": "tiny"})
    if direction == "port-to-jax":
        eng = TS.ContinuousBatcher(tp, tcfg, **ENGINE)
        eng.submit(PROMPT, 2)
        eng.run()
        payload = TD.export_prefix_pages(TH.EngineServer(eng), PROMPT)
        pages = eng.allocator.match_prefix(TPC.prefix_keys(PROMPT, 8))
        want_k = eng.cache.k[:, pages].view(torch.int16).numpy()
        want_v = eng.cache.v[:, pages].view(torch.int16).numpy()
        dt = JD._np_dtype(payload["dtype"])
        got_k = np.frombuffer(base64.b64decode(payload["k"]), dt).reshape(payload["shape"])
        got_v = np.frombuffer(base64.b64decode(payload["v"]), dt).reshape(payload["shape"])
        assert payload["dtype"] == "bfloat16" and str(dt) == "bfloat16"
    else:
        eng = JS.ContinuousBatcher(jp, LLAMA_TINY, **ENGINE)
        eng.submit(PROMPT, 2)
        eng.run()
        payload = JD.export_prefix_pages(JH.EngineServer(eng), PROMPT)
        want_k = np.frombuffer(base64.b64decode(payload["k"]), np.int16).reshape(payload["shape"])
        want_v = np.frombuffer(base64.b64decode(payload["v"]), np.int16).reshape(payload["shape"])
        dec = TH.EngineServer(TS.ContinuousBatcher(tp, tcfg, **ENGINE))
        assert TD.adopt_pages(dec, payload) == (3, 0)
        pages = dec.engine.allocator.match_prefix(TPC.prefix_keys(PROMPT, 8))
        got_k = dec.engine.cache.k[:, pages].view(torch.int16).numpy()
        got_v = dec.engine.cache.v[:, pages].view(torch.int16).numpy()
    assert payload["shape"] == [2, 3, 2, 8, 16]
    assert np.array_equal(got_k.view(np.int16), want_k) and np.array_equal(got_v.view(np.int16), want_v)
    assert np.any(want_k != 0)


@pytest.mark.parametrize("seed,n,page_len", [(0, 24, 8), (1, 257, 16), (2, 700, 256), (3, 7, 8)])
def test_prefix_keys_digests_equal_between_packages(seed, n, page_len):
    prompt = np.random.default_rng(seed).integers(0, 128_256, n).tolist()
    assert TPC.prefix_keys(prompt, page_len) == JPC.prefix_keys(prompt, page_len)
    assert len(TPC.prefix_keys(prompt, page_len)) == n // page_len


def test_dense_engine_refuses_both_routes(replicas):
    _, url = replicas("torch", kv="dense", page_len=256)
    for path in ("/v1/prefill", "/v1/kv/adopt"):
        st, body = _post(url + path, {"prompt_tokens": PROMPT})
        assert st == 409 and "paged" in body["error"]


def _break_page_len(p):
    p["page_len"] = 16


def _break_geometry(p):
    p["shape"] = [p["shape"][0], p["shape"][1], p["shape"][2] + 1, *p["shape"][3:]]


def _break_dtype(p):
    p["dtype"] = "bfloat16"


def _break_size(p):
    p["k"] = base64.b64encode(base64.b64decode(p["k"])[:-4]).decode("ascii")


@pytest.mark.parametrize("mutate,says", [(_break_page_len, "page_len mismatch"),
                                         (_break_geometry, "geometry mismatch"),
                                         (_break_dtype, "dtype mismatch"),
                                         (_break_size, "size does not match")],
                         ids=["page_len", "geometry", "dtype", "size"])
def test_adopt_refuses_a_mismatched_payload(params, replicas, mutate, says):
    eng = TS.ContinuousBatcher(params[1], config_from_dict({"preset": "tiny", "dtype": "float32"}),
                               **ENGINE)
    eng.submit(PROMPT, 1)
    eng.run()
    payload = TD.export_prefix_pages(TH.EngineServer(eng), PROMPT)
    dec, url = replicas("torch")
    mutate(payload)
    st, body = _post(url + "/v1/kv/adopt", payload)
    assert st == 400 and says in body["error"], body
    assert dec.kv_handoff_adopted == 0 and _stats(url)["pages_live"] == 0


def test_dead_decode_url_degrades_to_ship_error(replicas):
    import socket

    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    pre, url = replicas("torch", role="prefill")
    st, resp = _post(url + "/v1/prefill", {"prompt_tokens": PROMPT, "decode_url": dead, "timeout_s": 5})
    assert st == 200 and resp["ship_error"] and resp["pages"] == 3 and resp["adopted"] == 0
    assert resp["first_token"] is not None and pre.kv_handoff_exported == 3
