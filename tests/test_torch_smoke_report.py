"""``chip_smoke.py``'s build report and kernel families, on the CPU: the
parser that reads ptxas's ``-v`` report (a bf16 MoE pass, decode
instantiation or B6 kernel that spills fails the on-card run), the names
by which a profiled step is split, and the fleet phases' readers of the
lines ``tony serve`` and its replicas print, its ``tony loadtest`` traffic
and the jobs the launcher builds from its flags."""

import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MOE = "_ZN44_GLOBAL__N__70cdac86_11_moe_gemm_cu_8ae5b4a615moe_gemm_kernelILi{}EEEvNS_4MapsEPKiiiiP13__nv_bfloat16S5_S5_"
ATTN = ("_ZN50_GLOBAL__N__5ad67ba7_17_ring_attention_cu_9de2b4463hop15attn_fwd_kernelILi128ELb1EEEv"
        "14CUtensorMap_stS2_S2_PKiS4_PfS5_S5_P13__nv_bfloat16S5_NS_4GeomENS_4SpanEfii")


DECODE = "_ZN52_GLOBAL__N__5088215c_19_decode_attention_cu_5787c4f323decode_attention_kernelI{}Li{}EEEvNS_4ArgsE"
INT8_DECODE = ("_ZN47_GLOBAL__N__a5f2ff40_14_int8_matmul_cu_bc2b5f6116i8_decode_kernelILi{}EEEv14CUtensorMap_stS1_"
               "PKfP13__nv_bfloat16PfPiiiii")
INT8_PREFILL = ("_ZN47_GLOBAL__N__a5f2ff40_14_int8_matmul_cu_bc2b5f6117i8_prefill_kernelILi2EEEv14CUtensorMap_stS1_"
                "PKfP13__nv_bfloat16iii")


def _entry(name, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 2 barriers\n"
            "ptxas info    : Compile time = 62.700 ms\n")


LOG = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized\n"
       + _entry(MOE.format(5), 168) + _entry(ATTN, 168) + _entry(MOE.format(1), 168, spill=24)
       + "nvcc wall seconds: 6.2\n")
DECODE_LOG = (_entry(DECODE.format("f", 64), 232) + _entry(DECODE.format("f", 128), 255, spill=136)
              + _entry(DECODE.format("13__nv_bfloat16", 128), 180) + _entry(ATTN, 168)
              + "nvcc wall seconds: 10.1\n")


INT8_LOG = (_entry(INT8_DECODE.format(8), 168) + _entry(DECODE.format("f", 64), 232)
            + _entry(INT8_DECODE.format(1), 54) + _entry(INT8_PREFILL, 168, spill=16)
            + "nvcc wall seconds: 5.7\n")


def test_ptxas_entries_reads_each_int8_kernel_and_only_those():
    got = [(g, r["registers"], r["spill_stores"]) for g, r in cs.ptxas_entries(INT8_LOG, cs._PTXAS_INT8)]
    assert got == [(("decode", "8"), 168, 0), (("decode", "1"), 54, 0), (("prefill", "2"), 168, 16)]


def test_int8_kernels_match_the_source():
    """The build report expects one decode instantiation per column-tile count the
    launcher picks, and the prefill kernel; the wrapper's crossover is the source's."""
    from tony_tpu_torch.ops import quant as Q

    src = (ROOT / "tony_tpu_torch" / "csrc" / "int8_matmul.cu").read_text()
    mts = sorted({int(m) for m in re.findall(r"launch_decode<(\d)>\(", src)})
    wms = sorted({int(m) for m in re.findall(r"launch_prefill<(\d)>\(", src)})
    assert [("decode", m) for m in mts] + [("prefill", m) for m in wms] == cs.INT8_KERNELS
    assert int(re.search(r"constexpr int DECODE_MAX_M = (\d+);", src).group(1)) == Q.DECODE_MAX_M


def test_ptxas_entries_reads_each_moe_pass_and_only_those():
    got = cs.ptxas_entries(LOG, cs._PTXAS_MOE)
    assert [(cs.MOE_PASSES[int(p)], r) for (p,), r in got] == [
        ("dw_d", {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "registers": 168}),
        ("up_bwd", {"stack_frame": 0, "spill_stores": 24, "spill_loads": 24, "registers": 168}),
    ]


def test_ptxas_entries_reads_the_attention_kernels():
    (groups, rec), = cs.ptxas_entries(LOG, cs._PTXAS_KERNEL)
    assert groups == ("hop", "attn_fwd_kernel", "128", "1")
    assert rec["registers"] == 168 and rec["spill_stores"] == 0


def test_ptxas_entries_reads_each_decode_instantiation_and_only_those():
    got = [(g, r["registers"], r["spill_stores"]) for g, r in cs.ptxas_entries(DECODE_LOG, cs._PTXAS_DECODE)]
    assert got == [(("f", "64"), 232, 0), (("f", "128"), 255, 136), (("13__nv_bfloat16", "128"), 180, 0)]


def test_moe_passes_match_the_source_enum():
    src = (ROOT / "tony_tpu_torch" / "csrc" / "moe_gemm.cu").read_text()
    enum = re.search(r"enum Pass \{([^}]*)\}", src).group(1)
    assert [x.strip().lower() for x in enum.split(",")] == cs.MOE_PASSES


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::moe_gemm_kernel<1>((anonymous namespace)::Maps, int const*, int, int, int, "
     "__nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*)", "moe"),
    ("void (anonymous namespace)::hop::attn_bwd_dkv_kernel<128, false>(CUtensorMap_st, ...)", "attention"),
    ("void (anonymous namespace)::hop::attn_fwd_kernel<64, true>(CUtensorMap_st, ...)", "attention"),
    ("void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 128>((anonymous namespace)::Args)",
     "decode"),
    ("void (anonymous namespace)::decode_attention_kernel<float, 64>((anonymous namespace)::Args)", "decode"),
    ("void (anonymous namespace)::i8_decode_kernel<1>(CUtensorMap_st, CUtensorMap_st, float const*, "
     "__nv_bfloat16*, float*, int*, int, int, int, int)", "int8"),
    ("void (anonymous namespace)::i8_prefill_kernel<2>(CUtensorMap_st, CUtensorMap_st, float const*, "
     "__nv_bfloat16*, int, int, int)", "int8"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
])
def test_kernel_family(name, family):
    assert cs._kernel_family(name) == family


def test_gang_phase_reads_step_reports_and_the_obs_snapshot():
    """The gang phase's readers of a worker's stdout and ``.obs`` snapshot,
    on a snapshot of the port's own registry."""
    from tony_tpu_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    h = reg._register(metrics.Histogram, "tony_test_seconds", "", ())
    reg._register(metrics.Gauge, "tony_test_empty", "", ())
    for v in (0.5, 1.5, 4.0):
        h.observe(v)
    snap = reg.snapshot()
    assert cs._histogram(snap, "tony_test_seconds") == (3, 6.0)
    assert cs._histogram(snap, "tony_test_empty") is None
    out = ('[train] resumed from checkpoint step 4\n{"step": 5, "loss": 10.75, "grad_norm": 1.2}\n'
           'not json\n{"step": 6, "loss": 10.7, "grad_norm": 1.1}\n')
    assert {k: v["loss"] for k, v in cs._step_lines(out).items()} == {5: 10.75, 6: 10.7}


def test_gang_phase_reads_the_published_steps_of_a_worker_log():
    """The newest step attempt 0 shows published is where the restart must
    resume: only the checkpoint writer's own lines count, among step reports
    and other log lines."""
    out = ('{"step": 4, "loss": 10.8}\n[ckpt] step 4 published\n{"step": 5, "loss": 10.75}\n'
           '[train] urgent pre-preemption checkpoint at step 6\n[ckpt] step 8 published\n'
           'not [ckpt] step 9 published\n[ckpt] step 12 published later\n{"step": 9, "loss": 10.6}\n')
    assert cs._published_steps(out) == [4, 8]
    assert {k: v["loss"] for k, v in cs._step_lines(out).items()} == {4: 10.8, 5: 10.75, 9: 10.6}
    assert cs._published_steps("[train] resumed from checkpoint step 4\n") == []
    assert cs.GANG_CKPT_EVERY < cs.GANG_LOSS_AT - cs.GANG_CKPT_EVERY <= cs.GANG_STEPS - cs.GANG_CKPT_EVERY


@pytest.mark.parametrize("policy,per", [("full", 2), ("dots", 2), ("flash", 1)])
def test_remat_phases_expect_the_launch_schedule(policy, per):
    """B1 and B7 ``per`` times a layer, B2, B3 and B8 once, over a forward
    and backward; the counters a phase passes decide which kernels count."""
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG

    assert cs.REMAT_FWD_PER_LAYER[policy] == per
    assert cs._expected_launches((A,), 8, per) == {"flash_fwd": 8 * per, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    assert cs._expected_launches((A, MG), 2, per, steps=3) == {
        "flash_fwd": 6 * per, "flash_bwd_dq": 6, "flash_bwd_dkv": 6, "moe_fwd": 6 * per, "moe_bwd": 6}


@pytest.mark.parametrize("name", ["1chip", "moe"])
def test_bench_recipes_are_bench_pys_presets(name):
    """Each recipe builds, in the port, the configuration, batch and length
    of bench.py's preset of the same name (the JAX package's config, read
    here and never by ``chip_smoke.py``)."""
    import dataclasses

    pytest.importorskip("jax")
    import bench
    from tony_tpu_torch.models import llama, mixtral

    jmod, jcfg, jb, jt = bench._build_presets()[name]
    model, fields, B, T = cs.BENCH_RECIPES[name]
    cfg = {"llama": llama, "mixtral": mixtral}[model].config_from_dict(fields)
    port, jax_side = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert jmod.__name__.rsplit(".", 1)[-1] == model and (B, T) == (jb, jt)
    assert port == {k: v for k, v in jax_side.items() if k in port}
    assert set(jax_side) - set(port) <= {"capacity_factor", "moe_dispatch"}  # the port runs the ragged dispatch
    assert jax_side.get("moe_dispatch", "ragged") == "ragged"


def test_fleet_phase_reads_the_lines_the_fleet_prints(tmp_path):
    """The router line of ``tony serve``, a replica's start and drain lines:
    the formats in the two packages' sources, and the phase's readers of
    them, on a staging dir laid out as the executor lays it out."""
    serve_src = (ROOT / "tony_tpu_torch" / "models" / "serving_http.py").read_text()
    assert 'f"[tony-serve] {url} role={args.role} preset=' in serve_src
    assert 'f"[tony-serve] drained: {srv.requests_done} request(s) completed, exit 0"' in serve_src
    assert 'f"[tony-serve] fleet router {endpoint} → {replicas} replica(s)"' in (
        ROOT / "tony_tpu" / "cli" / "serve.py").read_text()
    launcher = ("[tony-serve] submitted application_1_0001 (1 replica(s))\n"
                "[tony-serve] fleet router http://127.0.0.1:41234 → 1 replica(s) + 1 prefill (POST ...)\n")
    assert cs._ROUTER_LINE.search(launcher).group(1) == "http://127.0.0.1:41234"
    logs = tmp_path / "application_1_0001" / "logs"
    for role, task, port in (("serve", "serve_0", 5001), ("prefill", "prefill_0", 5002)):
        (logs / task).mkdir(parents=True)
        (logs / task / "stdout.log").write_text(
            f"[tony-serve] http://127.0.0.1:{port} role={role} preset=llama3-8b device=cuda:0 kv=paged "
            "int8=False slots=8 max_len=2048\n[tony-serve] draining (budget 10s)\n"
            "[tony-serve] drained: 25 request(s) completed, exit 0\n")
    assert cs._replica_urls(tmp_path) == {"serve": "http://127.0.0.1:5001", "prefill": "http://127.0.0.1:5002"}
    text = (logs / "serve_0" / "stdout.log").read_text()
    assert cs._DRAINED_LINE.search(text).group(1) == "25"
    assert cs._DRAINED_LINE.search(text.replace("exit 0", "exit 1")) is None


@pytest.mark.parametrize("handoff", [True, False], ids=["disagg", "colocated"])
def test_fleet_line_names_every_number_and_the_card(handoff):
    rec = {"fleet": "disagg" if handoff else "colocated", "startup_s": 31.2, "requests_ok": 24,
           "tokens_per_sec": 120.5, "ttft_p50_ms": 250.0, "ttft_p95_ms": 600.0, "ttft_p99_ms": 700.0,
           "token_latency_p50_ms": 38.1, "latency_p50_ms": 2600.0, "latency_p99_ms": 3900.0,
           "prefix_hit_tokens": 5120, "b5_launches": 4096, "stop_s": 6.0,
           "kv_handoff_pages": 60 if handoff else None, "handoff_p50_ms": 900.0 if handoff else None}
    line = cs.fleet_line(rec, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith(f"[fleet] {rec['fleet']}: startup 31.2 s; 24/24 ok, 120.5 tok/s")
    for part in ("TTFT p50/p95/p99 250.0 / 600.0 / 700.0 ms", "gap between tokens p50 38.10 ms",
                 "latency p50/p99 2600.0 / 3900.0 ms", "B5 4096", "NVIDIA H100 80GB HBM3, 700.00 W"):
        assert part in line
    assert ("handoff p50 900.0 ms, 60 pages moved" in line) == handoff


def test_fleet_traffic_is_tony_loadtests_and_fits_the_engine():
    """``LOADTEST`` as ``tony loadtest`` parses it: 24 streamed requests, the
    shared prefix inside every first prompt, and the longest conversation
    (first prompt, then each turn's answer and fresh tokens) inside max_len."""
    pytest.importorskip("jax")
    from tony_tpu.cli.loadtest import build_spec

    spec, _ = build_spec(["--url", "http://127.0.0.1:1", *cs.LOADTEST])
    assert spec.sessions * spec.turns == cs.LOADTEST_REQUESTS == 24 and spec.stream
    assert sorted(n for n, _ in spec.prompt_mix) == [768, 1280] and spec.shared_prefix == 512
    longest = max(n for n, _ in spec.prompt_mix) + (spec.turns - 1) * (spec.max_tokens + spec.turn_tokens)
    assert longest + spec.max_tokens == 1488 < 1500 < cs.MAXT
    assert spec.vocab <= 128_256  # prompt ids inside Llama-3's vocabulary


@pytest.mark.parametrize("fleet", sorted(cs.FLEETS))
def test_fleet_jobs_run_the_port_on_the_card(fleet):
    """The launcher turns each fleet's flags into a job whose replicas run the
    port's server on the card, paged at the serve runs' geometry, with a
    prefill tier exactly when disaggregated."""
    pytest.importorskip("jax")
    from tony_tpu.config import keys
    from tony_tpu_torch_launch.serve import build_config

    config, _ = build_config([*cs.FLEET_ENGINE, *cs.FLEETS[fleet]])
    serve = config.get(keys.jobtype_key("serve", keys.COMMAND_SUFFIX))
    assert " -m tony_tpu_torch.models.serving_http --device cuda --preset llama3-8b " in serve
    for flag in ("--kv paged", f"--page-len {cs.PLEN}", f"--slots {cs.S}", f"--max-len {cs.MAXT}",
                 "--decode-chunk 8"):
        assert flag in serve
    prefill = config.get(keys.jobtype_key("prefill", keys.COMMAND_SUFFIX))
    if fleet == "disagg":
        assert prefill == serve + " --role prefill" and config.instances("prefill") == 1
    else:
        assert not config.get_bool(keys.SERVE_DISAGG_ENABLED, False)
    assert config.instances("serve") == 1


def test_kv_handoff_prompt_is_five_full_pages():
    """The [kv-handoff] prompt fills 5 pages, so a 5-page payload of
    2 x 32 x 5 x 8 x 256 x 128 x 2 bytes (k and v, bf16) crosses the wire."""
    from tony_tpu_torch.models.llama import PRESETS

    cfg = PRESETS["llama3-8b"]
    pages = cs.HANDOFF_PROMPT // cs.PLEN
    assert cs.HANDOFF_PROMPT % cs.PLEN == 0 and pages == 5
    assert 2 * cfg.n_layers * pages * cfg.n_kv_heads * cs.PLEN * cfg.head_dim * 2 == 167_772_160
