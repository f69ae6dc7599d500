"""The port's HTTP server on the CPU: /v1/completions (JSON and SSE),
/healthz, /stats, the disaggregated routes (a prefill leg with no decode
replica, a malformed adopt), drain on stop(), and SIGTERM → exit 0."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from tony_tpu_torch.models import serving_http as H  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


@pytest.fixture()
def server():
    args = H.parse_args(["--preset", "tiny", "--device", "cpu", "--slots", "2",
                         "--max-len", "64", "--page-len", "16", "--decode-chunk", "4"])
    srv = H.EngineServer(H.build_engine(args)).start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), type("Hd", (H._Handler,), {"server_ref": srv}))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    srv.stop(timeout_s=10)
    httpd.shutdown()


def test_completions_json_sse_stats_and_drain(server):
    srv, url = server
    assert srv.engine.kv == "paged"  # default where max_len is a multiple of page_len
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        assert json.load(r) == {"ok": True}
    body = {"prompt_tokens": list(range(1, 20)), "max_tokens": 6}
    with _post(url + "/v1/completions", body) as r:
        a = json.load(r)
    with _post(url + "/v1/completions", body) as r:
        b = json.load(r)
    assert a["finished"] and len(a["tokens"]) == 6 and a["tokens"] == b["tokens"]
    with _post(url + "/v1/completions", {**body, "stream": True}) as r:
        events = [json.loads(line[6:]) for line in r.read().decode().split("\n\n") if line]
    assert events[-1]["finished"] and events[-1]["tokens"] == a["tokens"]
    streamed = [t for e in events[:-1] for t in e["tokens"]]
    assert streamed == a["tokens"][:len(streamed)]  # chunks arrive in order, ahead of the end
    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        st = json.load(r)
    assert st["requests_done"] == 3 and st["prefix_hit_tokens"] > 0
    assert st["kernel_launches"]["paged_decode_attention"] == 0  # CPU: plain path only
    with _post(url + "/v1/prefill", body) as r:  # no decode_url: pages exported, none shipped
        leg = json.load(r)
    assert leg["first_token"] == a["tokens"][0] and (leg["pages"], leg["adopted"]) == (1, 0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/kv/adopt", body)  # not a page payload
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/completions", {"prompt_tokens": [1] * 60, "max_tokens": 10})
    assert e.value.code == 400
    assert srv.stop(timeout_s=10)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/v1/completions", body)
    assert e.value.code == 503


def test_main_serves_and_sigterm_exits_zero(tmp_path):
    url_file = tmp_path / "url"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.models.serving_http", "--preset", "tiny",
         "--device", "cpu", "--slots", "2", "--max-len", "64", "--kv", "dense",
         "--attn", "ragged", "--url-file", str(url_file)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while not url_file.exists():
            assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
            time.sleep(0.1)
        url = url_file.read_text()
        with _post(url + "/v1/completions", {"prompt_tokens": [5, 6, 7], "max_tokens": 4}) as r:
            assert len(json.load(r)["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
