"""The port's replicas as a ``tony serve`` fleet, on the CPU: the launcher
(``tony_tpu_torch_launch.serve``) builds the job, the AM runs port replicas
that register their URLs, push their stats and ``tony_serve_*``
instruments, and drain on kill; a disaggregated fleet (one prefill, one
decode replica) behind the JAX package's FleetRouter and DisaggCoordinator
serves the load generator's sessions through the KV handoff; the drain
control file and the AM registration frame on their own. Every wait is
bounded by a deadline."""

import json
import os
import threading
import time
import urllib.request

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from tony_tpu import constants  # noqa: E402
from tony_tpu.cli.notebook import wait_for_task_url  # noqa: E402
from tony_tpu.cli.serve import _fleet_am_client  # noqa: E402
from tony_tpu.cluster.client import Client  # noqa: E402
from tony_tpu.cluster.session import JobStatus  # noqa: E402
from tony_tpu.config import keys  # noqa: E402
from tony_tpu_torch_launch.serve import PORT_SERVER, build_config  # noqa: E402

FAST = {
    keys.AM_MONITOR_INTERVAL_MS: "50",
    keys.TASK_HEARTBEAT_INTERVAL_MS: "100",
    keys.TASK_METRICS_INTERVAL_MS: "300",
    keys.AM_GANG_TIMEOUT_MS: "60000",
}


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, json.dumps(body).encode(), {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _wait(pred, timeout_s, poll_s=0.2):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(poll_s)
    return None


def _submit(argv, root):
    config, _ = build_config(argv)
    config.set(keys.STAGING_ROOT, str(root))
    for k, v in FAST.items():
        config.set(k, v)
    client = Client(config)
    handle = client.submit()
    result: dict = {}
    mon = threading.Thread(
        target=lambda: result.update(final=client.monitor_application(handle, quiet=True)), daemon=True)
    mon.start()
    return config, handle, mon, result


def _kill_and_check_drains(handle, mon, result, root, tasks):
    Client.kill(handle)
    mon.join(timeout=90)
    assert not mon.is_alive(), "the job never finalized after kill"
    assert result.get("final") == JobStatus.KILLED, handle.final_status()
    logs = root / handle.app_id / "logs"
    for task in tasks:
        out = (logs / task / "stdout.log").read_text()
        assert "[tony-serve] draining" in out and "request(s) completed, exit 0" in out, out[-2000:]


@pytest.mark.e2e
def test_launcher_runs_port_replicas_under_the_am(tmp_tony_root):
    config, handle, mon, result = _submit(
        ["--preset", "tiny", "--slots", "2", "--max_len", "64", "--decode_chunk", "4",
         "--device", "cpu"], tmp_tony_root)
    assert f"-m {PORT_SERVER} --device cpu " in config.get(
        keys.jobtype_key(constants.SERVE_JOB_NAME, keys.COMMAND_SUFFIX))
    try:
        # 1. the port replica registers its URL through the AM
        host, port = wait_for_task_url(handle, constants.SERVE_JOB_NAME, timeout_s=120)
        url = f"http://{host}:{port}"
        st = _get(url + "/stats")
        assert st["device"] == "cpu" and "kernel_launches" in st and st["role"] == "serve"
        # 2. greedy completions are deterministic
        a = _post(url + "/v1/completions", {"prompt_tokens": [1, 2, 3], "max_tokens": 6})
        b = _post(url + "/v1/completions", {"prompt_tokens": [1, 2, 3], "max_tokens": 6})
        assert a["finished"] and len(a["tokens"]) == 6 and a["tokens"] == b["tokens"]
        # 3. the stats line and the tony_serve_* instruments reach the AM
        rpc = handle.rpc(timeout_s=10)
        assert rpc is not None

        def pushed():
            infos = rpc.call("get_task_infos")
            m = next((i.get("metrics") for i in infos if i["name"] == constants.SERVE_JOB_NAME), None) or {}
            names = {x["name"] for x in m.get("obs_metrics") or []}
            done = (m.get("train") or {}).get("requests_done", 0) >= 2
            return (m, names) if done and "tony_serve_ttft_seconds" in names else None

        got = _wait(pushed, timeout_s=30)
        assert got, rpc.call("get_task_infos")
        metrics, names = got
        assert {"tokens_per_s", "slots_active", "queue_depth"} <= set(metrics["train"])
        assert {"tony_serve_requests_total", "tony_serve_tokens_delivered_total",
                "tony_serve_token_latency_seconds", "tony_serve_queue_depth"} <= names
    finally:
        # 4. kill → each replica drains → KILLED
        _kill_and_check_drains(handle, mon, result, tmp_tony_root, ["serve_0"])


@pytest.mark.e2e
def test_disagg_fleet_serves_loadgen_through_the_handoff(tmp_tony_root):
    from tony_tpu.histserver import gate as bench_gate
    from tony_tpu.serve import DisaggCoordinator, FleetRouter, HealthMonitor, SessionTable
    from tony_tpu.serve.loadgen import LoadGenerator, LoadSpec

    _, handle, mon, result = _submit(
        ["--disagg", "--replicas", "1", "--prefill_replicas", "1", "--preset", "tiny",
         "--kv", "paged", "--page_len", "8", "--slots", "4", "--max_len", "128",
         "--decode_chunk", "4", "--device", "cpu"], tmp_tony_root)
    monitors, router, fleet_rpc = [], None, None
    try:
        for job in (constants.SERVE_JOB_NAME, constants.PREFILL_JOB_NAME):
            wait_for_task_url(handle, job, timeout_s=120)
        fleet_rpc = _fleet_am_client(handle)
        assert fleet_rpc is not None
        decode, prefill = (HealthMonitor(fleet_rpc.call, job_name=job, interval_s=0.2)
                           for job in (constants.SERVE_JOB_NAME, constants.PREFILL_JOB_NAME))
        for h in (decode, prefill):
            h.tick()
            h.start()
            monitors.append(h)
        router = FleetRouter(decode, sessions=SessionTable(), failover_deadline_s=60.0,
                             disagg=DisaggCoordinator(prefill, timeout_s=60.0)).start()
        spec = LoadSpec(url=router.url, rate=8.0, sessions=6, turns=3, prompt_mix=[(16, 1.0)],
                        max_tokens=4, shared_prefix=8, stream=True, timeout_s=120.0, seed=7,
                        vocab=256)  # the tiny preset's vocabulary: the port refuses ids past it
        report = LoadGenerator(spec).run()
        d = report.to_dict()
        assert d["requests_failed"] == 0 and d["requests_ok"] == 18, d.get("first_errors")
        assert d.get("kv_handoff_pages", 0) > 0 and d.get("handoff_p50_ms", 0) > 0, d
        assert d.get("prefix_hit_tokens", 0) > 0, d
        pre_url = prefill.snapshot()[0].url
        dec_url = decode.snapshot()[0].url
        pre, dec = _get(pre_url + "/stats"), _get(dec_url + "/stats")
        assert pre["role"] == "prefill" and pre["kv_handoff_exported"] > 0
        assert dec["role"] == "serve" and dec["kv_handoff_adopted"] > 0
        rec = report.to_bench_record(1)
        assert bench_gate.validate_record(rec, wrapper=True) == []
        assert rec["parsed"]["handoff_p50_ms"] > 0
    finally:
        if router is not None:
            router.stop()
        for h in monitors:
            h.stop()
        if fleet_rpc is not None:
            fleet_rpc.close()
        _kill_and_check_drains(handle, mon, result, tmp_tony_root, ["serve_0", "prefill_0"])


def test_drain_control_file_flips_draining_and_acks(tmp_path, monkeypatch):
    """The replica's half of the cooperative-preemption drain, and the
    metrics pump's two files, with the threads the server's main starts."""
    from tony_tpu_torch.models import serving_http as H

    metrics = tmp_path / "serve_0.json"
    monkeypatch.setenv("TONY_TRAIN_METRICS_FILE", str(metrics))
    monkeypatch.setenv("TONY_PROFILE_POLL_MS", "50")
    args = H.parse_args(["--preset", "tiny", "--device", "cpu", "--slots", "2", "--max-len", "64",
                         "--decode-chunk", "4"])
    srv = H.EngineServer(H.build_engine(args)).start()
    stop = threading.Event()
    threads = [threading.Thread(target=H._drain_watch, args=(srv, stop, 10.0), daemon=True),
               threading.Thread(target=H._metrics_pump, args=(srv, stop, 0.1), daemon=True)]
    for t in threads:
        t.start()
    try:
        out = srv.submit([1, 2, 3], 4, request_id="rid-1")
        while out.get(timeout=30)[0] != "done":
            pass
        assert _wait(lambda: metrics.exists() and os.path.exists(f"{metrics}.obs"), timeout_s=10)
        assert _wait(lambda: json.loads(metrics.read_text())["requests_done"] == 1, timeout_s=10)
        obs = {m["name"]: m for m in json.loads(open(f"{metrics}.obs").read())}
        assert obs["tony_serve_ttft_seconds"]["samples"][0]["exemplars"][0][1] == "rid-1"
        assert not srv.stats()["draining"]
        (tmp_path / "serve_0.json.drain").write_text(json.dumps({"req_id": "drain-7"}))
        done = _wait(lambda: H.introspect.read_json(f"{metrics}.drain.done"), timeout_s=20)
        assert done == {"req_id": "drain-7", "step": 1}
        assert srv.stats()["draining"]
        assert srv.submit([1, 2], 2).get(timeout=10) == ("error", "server is draining")
    finally:
        stop.set()
        srv.stop(timeout_s=10)
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_registration_frame_is_the_am_rpc_frame(monkeypatch):
    """The port's own RPC client against the control plane's server: the
    register_task_url call carries the task's identity, and a wrong secret
    is refused."""
    from tony_tpu.cluster.rpc import RpcServer
    from tony_tpu_torch.cluster.rpc import RpcClient, RpcError
    from tony_tpu_torch.models import serving_http as H

    calls = []
    server = RpcServer(secret="s3cret")
    server.register("register_task_url", lambda **kw: calls.append(kw) or True)
    server.start()
    try:
        host, port = server.address
        monkeypatch.setenv("TONY_AM_HOST", host)
        monkeypatch.setenv("TONY_AM_PORT", str(port))
        monkeypatch.setenv("TONY_AM_SECRET", "s3cret")
        monkeypatch.setenv("JOB_NAME", "prefill")
        monkeypatch.setenv("TASK_INDEX", "2")
        monkeypatch.setenv("TONY_RESTART_ATTEMPT", "1")
        H._register_with_am("http://127.0.0.1:8123")
        assert calls == [{"job_name": "prefill", "index": 2, "url": "http://127.0.0.1:8123", "attempt": 1}]
        cli = RpcClient(host, port, secret="wrong", timeout_s=5)
        with pytest.raises(RpcError, match="authentication"):
            cli.call("register_task_url", job_name="x", index=0, url="u", attempt=0)
        cli.close()
    finally:
        server.stop()
    assert H.own_host("127.0.0.1") == "127.0.0.1" and H.own_host("localhost") == "127.0.0.1"
