"""``chip_smoke.py``'s build report and kernel families, on the CPU: the
parser that reads ptxas's ``-v`` report (a bf16 MoE pass, decode
instantiation or B6 kernel that spills fails the on-card run), the names
by which a profiled step is split, and the fleet phases' readers of the
lines ``tony serve`` and its replicas print, its ``tony loadtest`` traffic
and the jobs the launcher builds from its flags."""

import math
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


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as each gang rank has: tier-1 runs this file
    beside other workers, and a tiny model's step on a full thread pool
    only waits for CPUs."""
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


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
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(...)", "other"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_"
     "execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64", "conv"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64", "conv"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false, 0, 0, int, float, float>(...)", "conv"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float, 512, true, 1>(...)", "norm"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, c10::BFloat16, "
     "float, 4>(...)", "norm"),
    ("void cutlass::Kernel2<cutlass::gemm::kernel::GemmUniversal<cutlass::NumericConverter<float, "
     "cutlass::bfloat16_t> > >(...)", "gemm"),
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


@pytest.mark.parametrize("name", ["1chip", "moe", "bert"])
def test_bench_recipes_are_bench_pys_presets(name):
    """Each recipe builds, in the port, the configuration, batch and length
    of bench.py's preset of the same name (the JAX package's config, read
    here and never by ``chip_smoke.py``)."""
    import dataclasses

    pytest.importorskip("jax")
    import bench
    from tony_tpu_torch.models import bert, llama, mixtral

    jmod, jcfg, jb, jt = bench._build_presets()[name]
    model, fields, B, T = cs.BENCH_RECIPES[name]
    cfg = {"llama": llama, "mixtral": mixtral, "bert": bert}[model].config_from_dict(fields)
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
    rec = {"fleet": "disagg" if handoff else "colocated", "startup_s": 31.2, "requests_ok": cs.LOADTEST_REQUESTS,
           "tokens_per_sec": 120.5, "ttft_p50_ms": 250.0, "ttft_p95_ms": 600.0, "ttft_p99_ms": 700.0,
           "token_latency_p50_ms": 38.1, "latency_p50_ms": 2600.0, "latency_p99_ms": 3900.0,
           "prefix_hit_tokens": 5120, "b5_launches": 4096, "stop_s": 6.0,
           "kv_handoff_pages": 60 if handoff else None, "handoff_p50_ms": 900.0 if handoff else None}
    line = cs.fleet_line(rec, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith(f"[fleet] {rec['fleet']}: startup 31.2 s; 4/4 ok, 120.5 tok/s")
    for part in ("TTFT p50/p95/p99 250.0 / 600.0 / 700.0 ms", "gap between tokens p50 38.10 ms",
                 "latency p50/p99 2600.0 / 3900.0 ms", "B5 4096", "NVIDIA H100 80GB HBM3, 700.00 W"):
        assert part in line
    assert ("handoff p50 900.0 ms, 60 pages moved" in line) == handoff


def test_fleet_traffic_is_tony_loadtests_and_fits_the_engine():
    """``LOADTEST`` as ``tony loadtest`` parses it: 4 streamed requests, the
    shared prefix inside every first prompt, and the longest conversation
    (first prompt, then each turn's answer and fresh tokens) inside max_len."""
    pytest.importorskip("jax")
    from tony_tpu.cli.loadtest import build_spec

    spec, _ = build_spec(["--url", "http://127.0.0.1:1", *cs.LOADTEST])
    assert spec.sessions * spec.turns == cs.LOADTEST_REQUESTS == 4 and spec.stream
    assert sorted(n for n, _ in spec.prompt_mix) == [768, 1280] and spec.shared_prefix == 512
    longest = max(n for n, _ in spec.prompt_mix) + (spec.turns - 1) * (spec.max_tokens + spec.turn_tokens)
    assert longest + spec.max_tokens == 1416 < 1500 < cs.MAXT
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


def test_llama_flash_cases_keep_their_values_and_bert_cases_read_theirs():
    """The Llama-3-8B cases keep their shapes (causal GQA, Dh 128), with
    ``[pp]``'s microbatch of one row beside them, and run in the early kernel
    phase; the BERT cases (bench.py's shape and packed rows, non-causal MHA,
    Dh 64) only in the BERT phases."""
    heads = dict(H=32, Hkv=8, Dh=128, causal=True)
    assert {n: cs.FLASH_CASES[n] for n in cs.LLAMA_FLASH_CASES} == {
        "train": dict(B=4, T=2048, window=0, n_seg=1, **heads),
        "long": dict(B=1, T=8192, window=0, n_seg=1, **heads),
        "segments": dict(B=4, T=2048, window=0, n_seg=3, **heads),
        "window": dict(B=4, T=2048, window=1024, n_seg=1, **heads),
        "pp": dict(B=1, T=2048, window=0, n_seg=1, **heads),
    }
    bert_heads = dict(H=12, Hkv=12, Dh=64, causal=False, window=0)
    assert cs.FLASH_CASES["bert"] == dict(B=384, T=512, n_seg=1, **bert_heads)
    assert cs.FLASH_CASES["bert_packed"] == dict(B=64, T=512, n_seg=3, pad=True, **bert_heads)
    assert set(cs.LLAMA_FLASH_CASES) | set(cs.BERT_FLASH_CASES) == set(cs.FLASH_CASES)
    pairs = 384 * 512 * 512  # non-causal: every pair of a row
    flops = {k: f for k, (f, _) in cs.flash_cost(cs.FLASH_CASES["bert"], pairs, None).items()}
    assert flops == {"flash_fwd": 4 * 12 * 64 * pairs, "flash_bwd_dq": 6 * 12 * 64 * pairs,
                     "flash_bwd_dkv": 8 * 12 * 64 * pairs}


def test_dropped_head_faults_drop_one_head_a_kv_group():
    import torch

    class FakeA:
        @staticmethod
        def flash_fwd(q, k, v, **kw):
            return q.clone(), None

    for H, Hkv, want in ((32, 8, [0, 4, 8, 12, 16, 20, 24, 28]), (12, 12, [0])):
        q = torch.ones(1, H, 2, 4)
        o, _ = cs.dropped_head_fwd(FakeA)(q, torch.ones(1, Hkv, 2, 4), None)
        assert [h for h in range(H) if not o[0, h].any()] == want


def test_bert_pack_documents_are_pack_abs():
    """The document stream and mask positions of ``examples/bert/pack_ab.py``."""
    import importlib.util

    import numpy as np

    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location("pack_ab", ROOT / "examples" / "bert" / "pack_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    docs = cs.bert_docs(64)
    want = ab.doc_stream(np.random.default_rng(0), 64)
    assert len(docs) == len(want) and all(np.array_equal(a, b) for a, b in zip(docs, want))
    assert all(cs.BERT_DOC_LEN[0] <= len(d) <= cs.BERT_DOC_LEN[1] for d in docs)
    tok, seg = cs.padded_rows(docs, cs.BERT_T)
    assert all(seg[i].sum() == len(d) and np.array_equal(tok[i, :len(d)], d) for i, d in enumerate(docs))
    np.testing.assert_array_equal(cs.masked_positions(np.random.default_rng(1), seg, 77),
                                  ab.masked_positions(np.random.default_rng(1), seg, 77))


def test_bench_and_bert_pack_lines_name_every_number():
    rec = {"params": 132_363_066, "mfu_params": 132_363_066, "batch": 384, "seq_len": 512, "remat": "full",
           "ce_chunk": None, "step_ms": 1047.4, "tok_per_s": 187_718.0, "mfu": 0.139,
           "mfu_basis": "6N + bidirectional attention at T=512, the head at 77 of 512 positions",
           "max_memory_gib": 22.7, "wall_s": 6.3,
           "launches": {"flash_fwd": 144, "flash_bwd_dq": 72, "flash_bwd_dkv": 72},
           "launches_per_step": {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}}
    line = cs.bench_line("bert", rec)
    for part in ("[bench-bert] bench.py's bert recipe (0.132 B params", "B=384 T=512, remat full",
                 "1047.4 ms/step, 187718 tok/s, MFU 0.139 (6N + bidirectional", "peak memory 22.7 GiB",
                 "a step {'flash_fwd': 24, 'flash_bwd_dq': 12, 'flash_bwd_dkv': 12}"):
        assert part in line
    arm = lambda rows, ms, tps: {"rows": rows, "step_ms": ms, "content_tok_per_s": tps}  # noqa: E731
    pack = {"padded": arm(384, 1142.3, 92934.2), "packed": arm(216, 613.8, 169720.4), "docs": 384,
            "pack_ratio": 384 / 216, "speedup": 1.826}
    line = cs.bert_pack_line(pack, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line == ("[bert-pack] padded 384 rows 1142.3 ms/step, 92934 content tok/s; packed 216 rows "
                    "613.8 ms/step, 169720 content tok/s; pack ratio 1.778 (384 documents), content speedup "
                    "1.826x; NVIDIA H100 80GB HBM3, 700.00 W")


def _kernel(case):
    return {"case": case, "max_abs_err": 1e-3, "tol": 1e-2, "ms": 1.0, "plain_ms": 9.0, "bound_ms": 0.5,
            "bound_by": "operations", "library_ms": 1.1, "cases": [{"case": case}]}


def test_kernel_rows_carry_the_bert_launches_and_cases_on_b1_b3_only():
    kern = {name: _kernel("train") for name in cs.KERNELS}
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    bert_kern = {name: _kernel("bert") for name in flash}
    path = {run: {name: 3 for name in cs.KERNELS} for _, _, run in cs.KERNELS.values()}
    bert_launches = {"flash_fwd": 144, "flash_bwd_dq": 72, "flash_bwd_dkv": 72}
    rows = cs.kernel_rows(kern, path, {"disagg": 7}, bert_launches, bert_kern)
    assert [r["name"] for r in rows] == list(cs.KERNELS)
    for r in rows:
        for key in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms"):
            assert key in r
        assert r["case"] == "train" and r["launches"] == 3
        assert ("launches_bert" in r) == (r["name"] in flash)
        if r["name"] in flash:
            assert r["launches_bert"] == bert_launches[r["name"]]
            assert [c["case"] for c in r["cases"]] == ["train", "bert"]
    assert rows[[r["name"] for r in rows].index("paged_decode_attention")]["launches_fleet"] == {"disagg": 7}
    with pytest.raises(cs.SmokeFailure, match="flash_bwd_dq was not launched by the bench-bert run"):
        cs.kernel_rows(kern, path, {}, {**bert_launches, "flash_bwd_dq": 0}, bert_kern)
    path["train"]["flash_fwd"] = 0
    with pytest.raises(cs.SmokeFailure, match="flash_fwd was not launched by the train run"):
        cs.kernel_rows(kern, path, {}, bert_launches, bert_kern)


def test_phases_print_a_start_line_and_seconds_and_name_a_failure(capsys):
    class FakeTorch:
        class cuda:
            @staticmethod
            def empty_cache():
                pass

    phases = cs.Phases(FakeTorch)
    with phases("one"):
        pass
    with pytest.raises(cs.SmokeFailure):
        with phases("two"):
            cs.check(False, "bad")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[phase] one start" and re.fullmatch(r"\[phase\] one \d+\.\ds", out[1])
    assert out[2:] == ["[phase] two start"] and phases.current == "two" and list(phases.seconds) == ["one"]


def test_resnet_and_mnist_constants_are_the_entry_points_and_the_jax_programs():
    """[bench-resnet] runs bench_resnet at its defaults, which are
    examples/resnet/bench_resnet.py's (read as text, never run); [mnist]
    reads train_mnist's step lines, whose steps, batch and interval are
    examples/mnist/train_mnist.py's."""
    from tony_tpu_torch.train import bench_resnet, train_mnist

    assert (cs.RESNET_BENCH_B, cs.RESNET_BENCH_STEPS, cs.RESNET_BENCH_WARMUP) == (
        bench_resnet.BATCH, bench_resnet.STEPS, bench_resnet.WARMUP)
    jax_bench = (ROOT / "examples" / "resnet" / "bench_resnet.py").read_text()
    defaults = dict(re.findall(r'add_argument\("--(\w+)", type=int, default=(\d+)\)', jax_bench))
    assert defaults == {"batch": str(bench_resnet.BATCH), "steps": str(bench_resnet.STEPS),
                        "warmup": str(bench_resnet.WARMUP)}
    assert f"FWD_GFLOP_PER_IMAGE = {bench_resnet.FWD_GFLOP_PER_IMAGE}" in jax_bench
    assert cs.MNIST_LOG_STEPS == list(range(train_mnist.LOG_EVERY, train_mnist.STEPS + 1, train_mnist.LOG_EVERY))
    jax_mnist = (ROOT / "examples" / "mnist" / "train_mnist.py").read_text()
    assert (f"range({train_mnist.STEPS})" in jax_mnist and f"total_steps={train_mnist.STEPS}" in jax_mnist
            and f", {train_mnist.BATCH}, cfg)" in jax_mnist and f"% {train_mnist.LOG_EVERY} == 0" in jax_mnist)


def test_mnist_phase_reads_train_mnists_step_lines(capsys):
    from tony_tpu_torch.train import train_mnist

    assert train_mnist.main(["--device", "cpu"]) == 0
    steps = [(int(a), float(b)) for a, b, _ in cs._STEP_LINE.findall(capsys.readouterr().out)]
    assert [s for s, _ in steps] == cs.MNIST_LOG_STEPS
    assert all(abs(loss - math.log(10)) <= cs.MNIST_LOSS_BAND for _, loss in steps)


def test_hf_and_mixtral_gang_phases_run_last_in_main():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    order = [main.index(f'phase("{name}")') for name in ("resnet-train", "hf-load", "hf-serve", "mixtral-gang")]
    assert order == sorted(order)
    load = src[src.index("def hf_load_phase("):src.index("def hf_requests(")]
    assert "fault=True" in load and 'check(bad == ["layers/wo"]' in load


@pytest.mark.parametrize("model", ["llama", "mixtral"])
def test_hf_dirs_the_phase_writes_load_bit_for_bit_and_the_planted_fault_fails(tmp_path, model):
    """``hf_state_dicts`` (the inverse map) and ``write_hf_dir`` in both
    layouts, read back by ``convert.load_hf_dir`` on the CPU: every leaf the
    source's; layer 0's ``o_proj`` untransposed differs in ``layers/wo``
    alone, with its shape unchanged."""
    import torch

    from tony_tpu_torch.models import convert, llama, mixtral

    mod = llama if model == "llama" else mixtral
    cfg = mod.config_from_dict({"preset": "tiny", "dtype": "bfloat16"})
    params = mod.init(torch.Generator().manual_seed(0), cfg, "cpu")
    for layout in ("safetensors", "bin"):
        d = tmp_path / layout
        size = cs.write_hf_dir(d, cfg, cs.hf_state_dicts(cfg, params), layout)
        assert size == sum(p.stat().st_size for p in d.iterdir() if p.suffix in (".safetensors", ".bin"))
        got, got_cfg = convert.load_hf_dir(d, "cpu")
        assert cs.tree_mismatches(torch, got, params) == []
        assert all(getattr(got_cfg, f) == getattr(cfg, f) for f in cs.HF_CONFIG_FIELDS if hasattr(cfg, f))
        cs.write_hf_dir(d, cfg, cs.hf_state_dicts(cfg, params, fault=True), layout)
        got, _ = convert.load_hf_dir(d, "cpu")
        assert cs.tree_mismatches(torch, got, params) == ["layers/wo"]
        assert got["layers"]["wo"].shape == params["layers"]["wo"].shape


def test_mixtral_gang_phase_reads_the_workers_step_and_launch_lines(capsys):
    """``pretrain_mixtral`` (cut by ``--n_layers``) prints the step reports
    with their ``moe_*`` metrics and the ``[train] kernel launches`` line the
    phase reads (all 0 on the CPU: the kernels launch on the card only)."""
    import json

    from tony_tpu_torch.train import pretrain_mixtral

    assert pretrain_mixtral.main(["--preset", "tiny", "--n_layers", "1", "--device", "cpu", "--steps", "2",
                                  "--batch_size", "2", "--seq_len", "16", "--log_every", "1"]) == 0
    out = capsys.readouterr().out
    steps = cs._step_lines(out)
    assert sorted(steps) == [1, 2] and all("moe_balance_loss" in s for s in steps.values())
    launches = json.loads(cs._LAUNCHES_LINE.search(out).group(1))
    assert set(launches) >= {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "moe_fwd", "moe_bwd"}
    assert not any(launches.values())


def test_kernel_rows_carry_the_later_phases_launches():
    kern = {name: _kernel("train") for name in cs.KERNELS}
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    bert_kern = {name: _kernel("bert") for name in flash}
    path = {run: {name: 3 for name in cs.KERNELS} for _, _, run in cs.KERNELS.values()}
    bert = dict.fromkeys(flash, 5)
    more = {"moe_fwd": {"mixtral_gang": 6, "hf_serve": 9}, "int8_matmul": {"hf_serve": 40}}
    rows = {r["name"]: r for r in cs.kernel_rows(kern, path, {}, bert, bert_kern, more)}
    assert rows["moe_fwd"]["launches_mixtral_gang"] == 6 and rows["moe_fwd"]["launches_hf_serve"] == 9
    assert rows["int8_matmul"]["launches_hf_serve"] == 40 and "launches_hf_serve" not in rows["moe_bwd"]
    with pytest.raises(cs.SmokeFailure, match="int8_matmul was not launched by the hf_serve phase"):
        cs.kernel_rows(kern, path, {}, bert, bert_kern, {"int8_matmul": {"hf_serve": 0}})


@pytest.fixture(scope="module")
def fsdp_record(tmp_path_factory):
    """``fsdp_phase`` on the CPU at the tiny Llama in f32: the gloo gang of
    two (one intra-op thread a rank), the one-process runs, the restores and
    the planted faults, as the card runs them at ``llama-1b``."""
    import torch

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.ops import attention as A

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cs.fsdp_phase(torch, llama, A, tmp_path_factory.mktemp("fsdp"), "cpu",
                             cfg={"preset": "tiny", "dtype": "float32"}, device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_fsdp_phase_holds_the_gang_to_one_process_and_catches_a_skipped_reduce_scatter(fsdp_record):
    """Each rank's losses are one process's (f32: within ``FSDP_REL``, here
    the same to the logged 4 decimals), the 9 split leaves of the tiny
    Llama and their two moments are blocks of the one-process restore bit
    for bit, the rank holds half of them, each rank's blocks of the last
    step's parameters and moments are one process's (f32: within 1e-5 of
    ``FSDP_STATE_REL``'s relative norm), the rank that skips the
    reduce-scatter moves the first step's grad norm past ``FSDP_REL``, and
    the rank that skips its moment update fails ``FSDP_STATE_REL`` on its
    first moment block (its moments stay zero: 1.0)."""
    rec = fsdp_record
    assert rec["losses"] == rec["one_losses"] and rec["worst_rel"] <= cs.FSDP_REL
    assert rec["split_leaves"] == 27 and rec["restored_step"] == cs.FSDP_STEPS
    assert rec["param_bytes"] + rec["opt_bytes"] < 0.51 * rec["whole_bytes"]
    assert set(rec["state_rel"]) == {"params", "mu", "nu"} and max(rec["state_rel"].values()) <= 1e-5
    assert abs(rec["fault_grad_norm"] - rec["fault_one_grad_norm"]) > cs.FSDP_REL * rec["fault_one_grad_norm"]
    assert rec["moments_fault"].startswith(f"moments fault rank {cs.FSDP_FAULT_RANK}'s block of mu/")
    assert rec["moments_fault"].split(": ")[-1].startswith("1.00e+00 > ")
    assert cs.FSDP_BACKEND == "gloo" and cs.FSDP_RANKS == 2


def test_fsdp_line_names_every_number_and_the_card(fsdp_record):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    line = cs.fsdp_line(fsdp_record, card)
    assert line.startswith("[fsdp] 2 ranks on one card over gloo, tiny B=8 T=32, fsdp 2: ") and line.endswith(card)
    for key in ("worst_rel", "restore_s"):
        assert key in fsdp_record
    for text in (str(fsdp_record["losses"]), str(fsdp_record["one_losses"]), str(fsdp_record["step_ms"]),
                 f"step {cs.FSDP_STEPS} restored into one process bit for bit", "skips the reduce-scatter",
                 "skips its moment update", f"(limit {cs.FSDP_STATE_REL:.0e})"):
        assert text in line, text


def test_fsdp_check_and_blocks_fail_on_a_wrong_norm_or_block():
    import torch

    one = [{"step": 1, "loss": 5.0, "grad_norm": 1.0}, {"step": 2, "loss": 4.9, "grad_norm": 0.9}]
    ok = {"log": [dict(x) for x in one]}
    assert cs.fsdp_check([{"ok": ok}, {"ok": ok}], one) == 0.0
    off = {"log": [dict(one[0], grad_norm=0.8)]}
    with pytest.raises(cs.SmokeFailure, match=r"rank 1 \(fault\) step 1 grad_norm 0.8"):
        cs.fsdp_check([{"fault": ok}, {"fault": off}], one, "fault")
    whole = {"params": {"w": torch.arange(8.0).reshape(2, 4), "n": torch.ones(3)}}
    ranks = [{"ok": {"saves": {"3": {
        "params/w": {"shape": [2, 2], "fp": cs.fingerprint(torch, whole["params"]["w"].chunk(2, 1)[r])},
        "params/n": {"shape": [3], "fp": cs.fingerprint(torch, whole["params"]["n"])}}}}} for r in range(2)]
    assert cs.fsdp_blocks(torch, ranks, whole, 3) == 1
    ranks[1]["ok"]["saves"]["3"]["params/w"]["fp"] = cs.fingerprint(torch, whole["params"]["w"].chunk(2, 1)[0])
    with pytest.raises(cs.SmokeFailure, match="rank 1's block of params/w"):
        cs.fsdp_blocks(torch, ranks, whole, 3)
    # the state check: rank 1's block of w off by 10% in mu fails, a whole leaf on rank 0
    one = {"params": dict(whole["params"]), "mu": dict(whole["params"]), "nu": dict(whole["params"])}
    gang = {"params": whole["params"], "opt_state": {"mu": dict(whole["params"]), "nu": whole["params"]}}
    saved = {name: {"shape": rec["shape"]} for name, rec in ranks[0]["ok"]["saves"]["3"].items()}
    assert cs.fsdp_state_check(torch, gang, one, saved, "sound") == {"params": 0.0, "mu": 0.0, "nu": 0.0}
    gang["opt_state"]["mu"]["w"] = torch.cat([whole["params"]["w"][:, :2], 1.1 * whole["params"]["w"][:, 2:]], 1)
    with pytest.raises(cs.SmokeFailure, match=r"off rank 1's block of mu/w: 1.00e-01 > "):
        cs.fsdp_state_check(torch, gang, one, saved, "off")


def test_fsdp_phase_runs_last_in_main():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert main.index('phase("mixtral-gang")') < main.index('phase("fsdp")') < main.index("except SmokeFailure")
    assert 'more[k]["fsdp"] = fsdp["launches_sum"][k]' in main


@pytest.fixture(scope="module")
def tp_records(tmp_path_factory):
    """``tp_phase`` and ``tp_serve_phase`` on the CPU at the tiny Llama in
    f32: the gloo gang of two on the model axis (one intra-op thread a
    rank), the one-process run, the restore and the planted faults; then
    the TP engine's two shards on the CPU against the tp=1 engine, as the
    card runs them at Llama-3-8B widths."""
    import torch

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.ops import attention as A

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tiny = {"preset": "tiny", "dtype": "float32"}
    try:
        return (cs.tp_phase(torch, llama, A, tmp_path_factory.mktemp("tp"), "cpu", cfg=tiny, device="cpu"),
                cs.tp_serve_phase(torch, llama, "cpu", cfg=tiny, device="cpu"))
    finally:
        torch.set_num_threads(threads)


def test_tp_phase_holds_the_gang_to_one_process_and_catches_both_faults(tp_records):
    """Each rank's losses and grad norms are one process's (f32: the same to
    the logged 4 decimals), the 9 leaves the model axis splits and their two
    moments are blocks of the one-process restore bit for bit, each rank
    holds half of them and launches B1-B3 as one process does (none on the
    CPU), its blocks of the last step's parameters and moments are one
    process's within 1e-5, the reduce whose backward also sums moves the
    first grad norm past ``FSDP_REL`` and the embedding that skips its sum
    the first loss."""
    rec, _ = tp_records
    assert rec["losses"] == rec["one_losses"] and rec["grad_norms"] == rec["one_grad_norms"]
    assert rec["worst_rel"] <= cs.FSDP_REL
    assert rec["split_leaves"] == 27 and rec["restored_step"] == cs.TP_STEPS
    assert rec["param_bytes"] + rec["opt_bytes"] < 0.51 * rec["whole_bytes"]
    assert set(rec["state_rel"]) == {"params", "mu", "nu"} and max(rec["state_rel"].values()) <= 1e-5
    assert rec["launches"] == [rec["one_launches"]] * cs.TP_RANKS
    assert set(rec["faults"]) == set(cs.TP_FAULTS)
    reduce, embed = rec["faults"]["reduce"], rec["faults"]["embed"]
    assert all(abs(g - rec["one_grad_norm"]) > cs.FSDP_REL * rec["one_grad_norm"] for g in reduce["grad_norm"])
    assert all(abs(x - rec["one_loss"]) > cs.FSDP_REL * rec["one_loss"] for x in embed["loss"])


def test_tp_serve_phase_gives_tp1s_tokens_and_catches_a_dropped_partial(tp_records):
    _, rec = tp_records
    assert len(rec["tokens"]) == len(cs.TP_SERVE_PROMPTS)
    assert all(len(t) == cs.TP_SERVE_TOKENS for t in rec["tokens"])
    assert rec["fault_changed"] > 0 and rec["tp1_ms"] > 0 and rec["tp2_ms"] > 0


def test_tp_lines_name_every_number_and_the_card(tp_records):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rec, serve = tp_records
    line = cs.tp_line(rec, card)
    assert line.startswith("[tp] 2 ranks on one card over gloo, tiny widths 2 layers B=2 T=32, model 2: ")
    assert line.endswith(card)
    for text in (str(rec["losses"]), str(rec["grad_norms"]), str(rec["step_ms"]), str(rec["launches"]),
                 f"step {cs.TP_STEPS} restored into one process bit for bit", "reduce: grad norm", "embed: grad norm",
                 f"(limit {cs.FSDP_STATE_REL:.0e})"):
        assert text in line, text
    line = cs.tp_serve_line(serve, card)
    assert line.startswith("[tp-serve] tiny widths 2 layers float32, 4 requests of 32 greedy tokens")
    for text in (f"tp 2 {serve['tp2_ms']:.2f} / tp 1 {serve['tp1_ms']:.2f}", "tokens equal tp 1's",
                 f"{serve['fault_changed']} of 4 requests' tokens changed, failed", card):
        assert text in line, text


def test_tp_checks_fail_on_a_wrong_norm_a_wrong_block_and_wrong_tokens(monkeypatch):
    """The [tp] checks name the phase: a grad norm off by 20% on one rank, a
    rank's block from its peer, and, in ``tp_serve_phase``, a TP engine
    whose shards' sum drops one partial for the whole phase (its tokens are
    no longer tp 1's)."""
    import torch

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.parallel import collectives

    one = [{"step": 1, "loss": 5.0, "grad_norm": 1.0}]
    off = {"log": [dict(one[0], grad_norm=0.8)]}
    with pytest.raises(cs.SmokeFailure, match=r"^tp: rank 1 \(reduce\) step 1 grad_norm 0.8"):
        cs.fsdp_check([{"reduce": {"log": one}}, {"reduce": off}], one, "reduce", tag="tp")
    whole = {"params": {"w": torch.arange(8.0).reshape(2, 4)}}
    ranks = [{"ok": {"saves": {"3": {"params/w": {"shape": [2, 2], "fp": cs.fingerprint(
        torch, whole["params"]["w"].chunk(2, 1)[0])}}}}} for _ in range(2)]
    with pytest.raises(cs.SmokeFailure, match="^tp: rank 1's block of params/w"):
        cs.fsdp_blocks(torch, ranks, whole, 3, tag="tp")
    real = collectives.DeviceModel.reduce_from_model
    monkeypatch.setattr(collectives.DeviceModel, "reduce_from_model",
                        lambda self, parts: real(self, parts[:-1] + [parts[-1] * 0]))
    with pytest.raises(cs.SmokeFailure, match="^tp-serve: tp 2 tokens"):
        cs.tp_serve_phase(torch, llama, "cpu", cfg={"preset": "tiny", "dtype": "float32"}, device="cpu")


def test_tp_phases_run_after_fsdp_in_main():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert main.index('phase("fsdp")') < main.index('phase("tp")') < main.index('phase("tp-serve")')
    assert main.index('phase("tp-serve")') < main.index("except SmokeFailure")
    assert 'more[k]["tp"] = tp["launches_rank"][k]' in main


@pytest.fixture(scope="module")
def mixtral_tp_records(tmp_path_factory):
    """``tp_phase`` for Mixtral and ``mixtral_tp_serve_phase`` on the CPU at
    the tiny Mixtral in f32 (``F/tp`` 64 on the plain B7/B8): the gloo gang
    of two on the model axis, the one-process run, the restore, the router's
    gradient on both ranks and the planted faults; then the TP engine's two
    shards on the CPU teacher-forced against the tp=1 engine, as the card
    runs them at Mixtral-8x7B widths."""
    import torch

    from tony_tpu_torch.models import mixtral
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tiny = {"preset": "tiny", "dtype": "float32"}
    try:
        return (cs.tp_phase(torch, mixtral, A, tmp_path_factory.mktemp("mixtral_tp"), "cpu", cfg=tiny, device="cpu"),
                cs.mixtral_tp_serve_phase(torch, mixtral, MG, "cpu", cfg=tiny, device="cpu"))
    finally:
        torch.set_num_threads(threads)


def test_mixtral_tp_phase_holds_the_gang_and_the_router_and_catches_both_faults(mixtral_tp_records):
    """Each rank's losses, grad norms and router losses are one process's
    within ``FSDP_REL`` (f32: rounding), the 27 leaves the model axis splits
    and their moments are blocks of the one-process restore bit for bit, each
    rank launches B1-B3, B7 and B8 as one process does (none on the CPU), the
    router's gradient is the same bits on both ranks at all 3 steps; the
    unsummed gates leave the first loss as it was (the forward is the same)
    and fail the router check, and the unreduced expert output moves the
    first loss past ``FSDP_REL``."""
    rec, _ = mixtral_tp_records
    assert rec["tag"] == "mixtral-tp" and rec["kernels"][3:] == ["moe_fwd", "moe_bwd"]
    assert rec["worst_rel"] <= cs.FSDP_REL and rec["router_steps"] == cs.TP_STEPS
    for got, want in ((rec["balance"], rec["one_balance"]), (rec["z"], rec["one_z"])):
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want, strict=True))
    assert rec["split_leaves"] == 27 and rec["restored_step"] == cs.TP_STEPS
    assert max(rec["state_rel"].values()) <= 1e-5
    assert rec["launches"] == [rec["one_launches"]] * cs.TP_RANKS
    assert set(rec["faults"]) == set(cs.MIXTRAL_TP_FAULTS)
    assert rec["faults"]["gates"]["loss"] == [rec["one_loss"]] * cs.TP_RANKS
    assert all(abs(x - rec["one_loss"]) > cs.FSDP_REL * rec["one_loss"] for x in rec["faults"]["expert"]["loss"])


def test_mixtral_tp_serve_phase_holds_the_logits_and_catches_a_dropped_expert_partial(mixtral_tp_records):
    """Teacher-forced on tp 1's tokens, every prefill and decode logits row
    of the tp=2 engine is tp 1's to f32 rounding (far inside the limit),
    every token routes as tp 1's on both shards, the argmax is held on the
    rows with a clear margin, and one shard's expert partial dropped fails
    ``forced_check``: rows far off tp 1's, or most of them rerouted."""
    _, rec = mixtral_tp_records
    assert rec["rows"] == len(rec["row_errs"]) == len(cs.TP_SERVE_PROMPTS) * cs.MIXTRAL_TP_SERVE_TOKENS
    assert rec["shards_alike"] and rec["flipped_errs"] == []
    assert rec["worst_row"] <= 1e-5 and rec["argmax_rows"] == rec["argmax_kept"] > 0
    fault = rec["fault"]
    assert (fault["worst_row"] > cs.MIXTRAL_TP_SERVE_ROW_TOL
            or len(fault["flipped_errs"]) > cs.MIXTRAL_TP_SERVE_FLIPS * fault["rows"])
    assert rec["greedy_equal"] == len(cs.TP_SERVE_PROMPTS)
    assert rec["expert_block"] == [2, 4, 64, 64] and rec["tp1_ms"] > 0 and rec["tp2_ms"] > 0


def test_forced_check_holds_rerouted_rows_apart_and_counts_them():
    """A row whose own token routed otherwise than tp 1's is left out of
    the row limit and counted; more than ``MIXTRAL_TP_SERVE_FLIPS`` of them,
    a held row past the limit, shards that route apart or a lost argmax on
    a clear margin fail."""
    import torch

    ref = torch.tensor([[4.0, 1.0, 0.0], [0.0, 1.0, 2.0], [1.0, 0.5, 0.0]])
    route = lambda *e: [[torch.tensor([list(e)])]]  # noqa: E731  one layer, one shard
    ref_routes = [[route(0, 1), route(0, 2), route(1, 2)]]
    got = ref + torch.tensor([[0.01, 0, 0], [1.0, 0, 0], [0, 0, 0.02]])
    routes = [[[[torch.tensor([[0, 1]]), torch.tensor([[0, 1]])]], [[torch.tensor([[0, 3]])] * 2],
               [[torch.tensor([[1, 2]])] * 2]]]
    reading = cs.forced_reading(torch, [got], routes, [ref], ref_routes)
    assert reading["rows"] == 3 and reading["flipped_errs"] == [0.5] and reading["shards_alike"]
    assert reading["row_errs"] == pytest.approx([0.0025, 0.02], abs=1e-6)
    assert reading["argmax_rows"] == reading["argmax_kept"] == 2
    with pytest.raises(cs.SmokeFailure, match="1 of 3 rows' tokens routed otherwise"):
        cs.forced_check(reading)
    many = dict(reading, rows=20)
    cs.forced_check(many)
    for bad, text in ((dict(many, worst_row=0.2), "a teacher-forced logits row of tp 2 is 2.00e-01"),
                      (dict(many, shards_alike=False), "shards routed a token differently"),
                      (dict(many, argmax_kept=0), "argmax differs from tp 1's on 2 rows")):
        with pytest.raises(cs.SmokeFailure, match=text):
            cs.forced_check(bad)


def test_mixtral_tp_lines_name_every_number_and_the_card(mixtral_tp_records):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rec, serve = mixtral_tp_records
    line = cs.tp_line(rec, card)
    assert line.startswith("[mixtral-tp] 2 ranks on one card over gloo, tiny widths 2 layers B=1 T=32, model 2: ")
    assert line.endswith(card)
    for text in (str(rec["losses"]), str(rec["balance"]), str(rec["z"]), str(rec["launches"]),
                 "flash_fwd/flash_bwd_dq/flash_bwd_dkv/moe_fwd/moe_bwd a rank",
                 f"the same bits on both ranks at {cs.TP_STEPS} steps", "gates: grad norm",
                 "the ranks router gradients differ, failed", "expert: grad norm"):
        assert text in line, text
    line = cs.mixtral_tp_serve_line(serve, card)
    assert line.startswith("[mixtral-tp-serve] tiny widths 2 layers float32, 4 requests of 16 greedy tokens")
    for text in (f"worst {serve['worst_row']:.2e} (limit {cs.MIXTRAL_TP_SERVE_ROW_TOL:.0e})",
                 f"tp 2 {serve['tp2_ms']:.2f} / tp 1 {serve['tp1_ms']:.2f}", "0 routed otherwise",
                 f"worst row routed as tp 1 {serve['fault']['worst_row']:.2e}",
                 "expert blocks [2, 4, 64, 64] contiguous, routing alike", card):
        assert text in line, text


def test_mixtral_tp_checks_fail_on_differing_routers_and_a_dropped_partial(monkeypatch):
    """The router check names the step whose fingerprints differ, and
    ``mixtral_tp_serve_phase`` whose shards drop their expert partials for
    the whole phase fails ``forced_check``."""
    import torch

    from tony_tpu_torch.models import generate, mixtral
    from tony_tpu_torch.ops import moe_gemm as MG

    ok = {"router": [[1, 2], [3, 4]]}
    assert cs.router_check([{"ok": ok}, {"ok": ok}]) == 2
    with pytest.raises(cs.SmokeFailure, match=r"^mixtral-tp: \(ok\) the ranks' router gradients differ at step 2"):
        cs.router_check([{"ok": ok}, {"ok": {"router": [[1, 2], [3, 5]]}}])
    real = generate._ffn_with_cache
    monkeypatch.setattr(generate, "_ffn_with_cache",
                        lambda h, lp, cfg: real(h, lp, cfg) * (0 if lp["we_gate"].shape[-1] == 64 else 1))
    with pytest.raises(cs.SmokeFailure, match=r"^mixtral-tp-serve: (a teacher-forced logits row|\d+ of \d+ rows')"):
        cs.mixtral_tp_serve_phase(torch, mixtral, MG, "cpu", cfg={"preset": "tiny", "dtype": "float32"},
                                  device="cpu")


def test_mixtral_tp_phases_run_after_tp_serve_in_main():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert main.index('phase("tp-serve")') < main.index('phase("mixtral-tp")') < main.index('phase("mixtral-tp-serve")')
    assert main.index('phase("mixtral-tp-serve")') < main.index("except SmokeFailure")
    assert 'more[k]["mixtral_tp"] = mixtral_tp["launches_rank"][k]' in main
    assert 'more["moe_fwd"]["mixtral_tp_serve"] = mixtral_tp_serve["launches"]' in main


def test_mixtral_ep_holds_the_expert_axis_to_one_process_and_catches_both_faults(mixtral_tp_records):
    """``[mixtral-ep]``, run by the same gang on the CPU at the tiny Mixtral
    (4 experts: 2 a rank) in f32: each rank's losses, grad norms and router
    losses are one process's within ``FSDP_REL`` (rounding), the router's
    gradient the same bits on both ranks at every step, the 3 expert leaves
    and their moments split and restored bit for bit, each rank's bytes the whole less half of
    the experts' exactly, B1-B3/B7/B8 launched as by one process (none on
    the CPU) with every B7/B8 call on 2 experts; the unsummed output and
    expert 0's span each move the first loss past ``FSDP_REL``."""
    rec = mixtral_tp_records[0]["ep"]
    assert rec["tag"] == "mixtral-ep" and rec["local_experts"] == 2 and rec["kernels"][3:] == ["moe_fwd", "moe_bwd"]
    assert rec["worst_rel"] <= cs.FSDP_REL and rec["router_steps"] == cs.TP_STEPS
    for got, want in ((rec["balance"], rec["one_balance"]), (rec["z"], rec["one_z"])):
        assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want, strict=True))
    assert rec["split_leaves"] == 9 and rec["restored_step"] == cs.TP_STEPS  # 3 leaves and their moments
    assert max(rec["state_rel"].values()) <= 1e-5
    assert rec["param_bytes"] + rec["opt_bytes"] == rec["whole_bytes"] - rec["expert_bytes"] // 2
    assert rec["launches"] == [rec["one_launches"]] * cs.TP_RANKS
    assert set(rec["faults"]) == set(cs.MIXTRAL_EP_FAULTS)
    one = rec["one_losses"][0]
    for fault in cs.MIXTRAL_EP_FAULTS:
        assert all(abs(x - one) > cs.FSDP_REL * one for x in rec["faults"][fault]["loss"]), fault


def test_mixtral_ep_line_names_every_number_and_fails_on_a_missing_field(mixtral_tp_records):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rec = mixtral_tp_records[0]["ep"]
    line = cs.ep_line(rec, card)
    assert line.startswith("[mixtral-ep] 2 ranks on one card over gloo, tiny widths 2 layers B=1 T=32, expert 2 "
                           "(2 experts a rank): ")
    assert line.endswith(card)
    for text in (str(rec["losses"]), str(rec["grad_norms"]), str(rec["balance"]), str(rec["z"]), str(rec["launches"]),
                 f"worst rel {rec['worst_rel']:.2e}, limit {cs.FSDP_REL:.0e}",
                 f"the same bits on both ranks at {cs.TP_STEPS} steps", "each B7/B8 call on 2 experts",
                 "exactly less half of the experts'", "(9 leaves split)", "unsummed: loss", "span0: loss",
                 f"restored into one process bit for bit in {rec['restore_s']:.1f} s"):
        assert text in line, text
    for key in rec:
        if key in ("tag", "steps", "one_launches", "launches_rank", "split_leaves") or key.startswith("one_"):
            continue
        with pytest.raises(KeyError):
            cs.ep_line({k: v for k, v in rec.items() if k != key}, card)


def test_mixtral_ep_launches_and_the_ep2_kernel_case_reach_the_report():
    """``main`` adds ``[mixtral-ep]``'s launches a rank to each kernel row
    it launched, and the MoE kernel phase times B7/B8 on a ``[mixtral-ep]``
    rank's span: 4 of the 8 experts, 2048 tokens routed top-2."""
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert 'more[k]["mixtral_ep"] = mixtral_tp["ep"]["launches_rank"][k]' in main
    assert cs.MOE_CASES["ep2"] == dict(tokens=2048, skew="random", experts=cs.MOE_E // 2)
    assert cs.MIXTRAL_EP_RUNS == ("ep-ok", "ep-unsummed", "ep-span0")


@pytest.fixture(scope="module")
def cp_records(tmp_path_factory):
    """``cp_train_mixtral`` and ``cp_gang_phase`` on the CPU at the tiny
    Llama and Mixtral in f32 through the plain B9/B10 steps: the context of
    4 in one process against none, and the gloo gang of two with one
    context shard each (one intra-op thread a rank) against one process,
    with the restore and the planted faults, as the card runs them at full
    widths."""
    import torch

    from tony_tpu_torch.models import llama, mixtral
    from tony_tpu_torch.ops import attention as A
    from tony_tpu_torch.ops import moe_gemm as MG
    from tony_tpu_torch.ops import ring as TR

    tiny = {"preset": "tiny", "dtype": "float32", "cp_impl": "pallas"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return (cs.cp_train_mixtral(torch, mixtral, A, MG, TR, cfg=tiny, T=32, device="cpu"),
                cs.cp_gang_phase(torch, llama, mixtral, A, tmp_path_factory.mktemp("cp_gang"), "cpu",
                                 cfgs={"llama": tiny, "mixtral": tiny}, T=(32, 32), device="cpu"))
    finally:
        torch.set_num_threads(threads)


def test_cp_train_mixtral_holds_the_context_run_to_the_run_without(cp_records):
    """A12a's smoke on the CPU: Mixtral's losses with a context of 4 are those
    without a context axis (f32: within 1e-6), no kernel launched on the
    CPU, and the schedule's launches computed for the card."""
    rec, _ = cp_records
    assert max(rec["loss_rel"]) <= 1e-6 and len(rec["losses"]) == cs.CP_MOE_STEPS
    assert not any(rec["launches"].values())
    L, S = rec["layers"], cs.CP_MOE_STEPS
    assert rec["launches_want"]["moe_fwd"] == 2 * L * S and rec["launches_want"]["moe_bwd"] == L * S
    assert rec["launches_want"]["ring_bwd_dq"] < rec["launches_want"]["ring_fwd"] // 2  # causal steps skipped


def test_cp_gang_phase_holds_the_gang_to_one_process_and_catches_both_faults(cp_records):
    """A12b's smoke on the CPU: each rank's Llama and Mixtral losses, grad
    norms and router losses are one process's (f32: within 1e-5), each
    family's save restores into one process bit for bit and its parameters
    and moments are one process's within 1e-5, no kernel launched on the
    CPU, and the ring
    that keeps KV local and RoPE without the window's offset each move the
    first loss past ``FSDP_REL``."""
    _, rec = cp_records
    for fam in ("llama", "mixtral"):
        assert rec[fam]["worst_rel"] <= 1e-5 and rec[fam]["losses"] == rec[fam]["one_losses"]
        assert rec[fam]["launches"] == [{}, {}]
        assert rec[fam]["restored_step"] == cs.CP_GANG_STEPS and max(rec[fam]["state_rel"].values()) <= 1e-5
    assert set(rec["faults"]) == set(cs.CP_GANG_FAULTS)
    one = rec["llama"]["one_losses"][0]
    for fault, got in rec["faults"].items():
        assert all(abs(x - one) > cs.FSDP_REL * one for x in got["loss"]), fault
    line = cs.cp_gang_line(rec, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith("[cp-gang] 2 ranks on one card over gloo, context 2, cp_impl pallas: tiny widths 2 layers")
    for text in ("local-kv: loss", "rope: loss", "balance", "NVIDIA H100 80GB HBM3, 700.00 W"):
        assert text in line, text
    assert line.count("the save restored into one process bit for bit") == 2


def test_cp_gang_launches_follow_the_causal_schedule():
    """Rank 0 of a causal ring of 2 skips its backward step over the future
    window; both run every forward step (the first and the last always)."""
    from tony_tpu_torch.ops import ring as TR

    r0, r1 = (cs.cp_gang_launches(TR, my, 2, 3, 8192, moe=False) for my in (0, 1))
    assert r0["ring_fwd"] == r1["ring_fwd"] == 2 * 2 * 3 * 2
    assert (r0["ring_bwd_dq"], r1["ring_bwd_dq"]) == (2 * 3, 2 * 3 * 2)
    assert cs.cp_gang_launches(TR, 0, 1, 3, 4096, moe=True)["moe_fwd"] == 6


def test_ring_phase_holds_the_kernels_at_the_context_gangs_shape():
    """The ring phase also holds B9/B10 against their plain steps on a ring
    of ``CP_GANG_RANKS`` over ``CP_GANG_T`` (each rank's window, and the
    causal schedule of that ring), its fault at that ring's past step."""
    cases = {c.get("n", cs.RING_N): c for c in cs.RING_CASES.values()}
    assert cs.RING_T == cs.CP_GANG_T and cases[cs.CP_GANG_RANKS] == dict(window=0, n_seg=1, n=cs.CP_GANG_RANKS,
                                                                         check_only=True)
    calls = []
    step = cs.skipped_ring_step(type("TR", (), {"ring_fwd_step": staticmethod(lambda **kw: calls.append(kw))}),
                                1, 0, 2)
    assert step(q_pos0=8192, k_pos0=0) is None and not calls
    step(q_pos0=8192, k_pos0=8192)
    assert calls == [dict(q_pos0=8192, k_pos0=8192)]


def test_cp_phases_run_in_main_and_reach_the_report():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert 'cp_train["mixtral"] = cp_train_mixtral(torch, mixtral, A, MG, TR)' in main
    assert main.index('phase("mixtral-tp-serve")') < main.index('phase("cp-gang")') < main.index("except SmokeFailure")
    assert 'more[k]["cp_gang"] = n' in main and '["cp_train_mixtral"]' in main


@pytest.fixture(scope="module")
def cp_tp_record(tmp_path_factory):
    """``cp_tp_phase`` on the CPU at the tiny Llama in f32 through the plain
    B9/B10 steps: the gloo gang of four on ``context 2 × model 2`` (one
    intra-op thread a rank) against one process with the context of 2,
    with the restore and both planted faults, as the card runs it at
    Llama-3-8B widths."""
    import torch

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.ops import attention as A

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cs.cp_tp_phase(torch, llama, A, tmp_path_factory.mktemp("cp_tp"), "cpu",
                              cfg={"preset": "tiny", "dtype": "float32", "cp_impl": "pallas"}, T=32, device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_cp_tp_phase_holds_the_gang_to_one_process_and_catches_both_faults(cp_tp_record):
    """A12c's smoke on the CPU: each rank's losses and grad norms are one
    process's (f32: within 1e-5), the step-1 attention gradients joined over
    the model line too, the save restores into one process bit for bit with
    every model-split leaf's blocks, the state within 1e-5, no kernel
    launched on the CPU, and the ring across the model lines and the
    context-line sum each fail a check; the line names every number and the
    card."""
    rec = cp_tp_record
    assert rec["worst_rel"] <= 1e-5 and rec["losses"] == rec["one_losses"] and len(rec["losses"]) == cs.CP_TP_STEPS
    assert rec["worst_grad_rel"] <= 1e-5 and (rec["heads"], rec["kv_heads"]) == (2, 1)
    assert rec["launches"] == [{}] * cs.CP_TP_RANKS and rec["split_leaves"] >= 9
    assert rec["restored_step"] == cs.CP_TP_STEPS and max(rec["state_rel"].values()) <= 1e-5
    assert set(rec["faults"]) == set(cs.CP_TP_FAULTS)
    one = rec["one_losses"][0]
    for fault, got in rec["faults"].items():
        moved = [abs(x - one) > cs.FSDP_REL * one for x in got["loss"]]
        assert any(moved) or got["worst_grad_rel"] > cs.CP_STEP_GRAD_REL, (fault, got)
    line = cs.cp_tp_line(rec, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith("[cp-tp] 4 ranks on one card over gloo, context 2 x model 2, cp_impl pallas: tiny widths")
    for text in ("cross-line: loss", "context-sum: loss", "joined over the model line",
                 "the save restored into one process bit for bit", "NVIDIA H100 80GB HBM3, 700.00 W"):
        assert text in line, text


def test_cp_tp_ring_fault_crosses_the_model_lines_and_keeps_the_windows():
    """The ring fault's lines pair each window with the other model index's
    rank of the other window (so its KV heads are another rank's), each rank
    at its own window's ring position."""
    lines = cs.crossed_context_lines()
    assert lines == [[0, 3], [1, 2]]
    assert all(r // cs.CP_TP_MODEL == pos for line in lines for pos, r in enumerate(line))
    assert all(len({r % cs.CP_TP_MODEL for r in line}) == cs.CP_TP_MODEL for line in lines)


def test_ring_phase_times_the_kernels_at_cp_tps_shape():
    """The ring phase's ``cp2xtp2`` case: a ``[cp-tp]`` rank's 16 query and 4
    kv heads over T=8192 on a ring of 2, timed, its bytes and operations
    those of its heads and length; ``causal-n2`` stays the case of
    ``[cp-gang]``'s ring of 2."""
    c = cs.RING_CASES["cp2xtp2"]
    assert c == dict(window=0, n_seg=1, n=cs.CP_TP_CONTEXT, T=cs.CP_TP_T, H=cs.H // cs.CP_TP_MODEL,
                     Hkv=cs.HKV // cs.CP_TP_MODEL)
    full, half = cs.ring_cost(100, None), cs.ring_cost(100, None, c)
    assert half["ring_fwd"][0] * 2 == full["ring_fwd"][0]  # half the heads: half the operations a pair
    assert half["ring_fwd"][1] * 4 == full["ring_fwd"][1]  # half the heads over half the length
    calls = []
    step = cs.skipped_ring_step(type("TR", (), {"ring_fwd_step": staticmethod(lambda **kw: calls.append(kw))}),
                                1, 0, 2, cs.CP_TP_T)
    assert step(q_pos0=4096, k_pos0=0) is None and not calls


def test_cp_tp_phase_runs_after_cp_gang_in_main_and_reaches_the_report():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert main.index('phase("cp-gang")') < main.index('phase("cp-tp")') < main.index("except SmokeFailure")
    assert 'more["ring_fwd"]["cp_tp"] = tp_sum["ring_fwd"]' in main
    assert '"cp_tp": cp_tp' in main


@pytest.fixture(scope="module")
def pp_record(tmp_path_factory):
    """``pp_phase`` on the CPU at the tiny Llama and Mixtral in f32 (the
    bf16 wire): the gloo gang of two, one stage each (one intra-op thread a
    rank), against one process's accumulated step, with the restores and
    the three planted faults, as the card runs them at full widths."""
    import torch

    from tony_tpu_torch.models import llama, mixtral

    tiny = {"preset": "tiny", "dtype": "float32"}
    return cs.pp_phase(torch, llama, mixtral, tmp_path_factory.mktemp("pp"), "cpu",
                       cfgs={"llama": tiny, "mixtral": tiny}, B=4, T=32, device="cpu")


def test_pp_phase_holds_the_gang_to_one_process_and_catches_every_fault(pp_record):
    """A13a's smoke on the CPU: each family's losses and grad norms are one
    process's within ``FSDP_REL``, its step-1 gradients (the router too)
    within ``CP_STEP_GRAD_REL``, its save restored bit for bit and its state
    within ``FSDP_STATE_REL``, no kernel launched on the CPU; the stale
    residual moves the loss, the short schedule leaves it and moves stage
    0's gradients, the unseeded aux leaves it and moves the router's."""
    rec = pp_record
    for fam, steps in (("llama", cs.PP_STEPS), ("mixtral", cs.PP_MOE_STEPS)):
        r = rec[fam]
        assert r["worst_rel"] <= cs.FSDP_REL and len(r["losses"]) == steps
        assert r["worst_grad"] <= cs.CP_STEP_GRAD_REL and r["router_err"] <= cs.CP_STEP_GRAD_REL
        assert r["launches"] == [{}, {}] and r["ticks"] == cs.PP_M + 2 * cs.PP_RANKS - 1
        # the schedule's clocks: no device to wait for on the CPU; the
        # fastest tick's exchange times the ticks within the exchanges' sum
        assert r["sync_share"] == [0, 0] and all(0 <= t <= e for t, e in zip(r["transfer_share"], r["exchange_share"]))
        assert r["restored_step"] == steps and max(r["state_rel"].values()) <= cs.FSDP_STATE_REL
    assert rec["mixtral"]["router_err"] > 0
    faults = rec["faults"]
    assert set(faults) == set(cs.PP_FAULTS)
    moved = {k: [abs(x - v["one_loss"]) > cs.FSDP_REL * v["one_loss"] for x in v["loss"]] for k, v in faults.items()}
    assert all(moved["stale-residual"]) and not any(moved["short-schedule"]) and not any(moved["aux-unseeded"])
    assert faults["short-schedule"]["worst_grad"] > cs.CP_STEP_GRAD_REL
    assert faults["aux-unseeded"]["worst_leaf"] == "layers/router"
    line = cs.pp_line(rec, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert line.startswith("[pp] 2 ranks on one card over gloo, stage 2, 1F1B: tiny widths 2 layers B=4 T=32 M=4")
    for text in ("stale-residual: loss", "short-schedule: loss", "aux-unseeded: loss", "router",
                 "ring exchange", "ticks a step", "reckoned a rank", "NVIDIA H100 80GB HBM3, 700.00 W"):
        assert text in line, text
    assert line.count("the save restored into one process bit for bit") == 2


def test_pp_launches_follow_the_1f1b_schedule_under_full_remat():
    """A stage of L/S layers launches B1 (and B7) three times a layer and
    microbatch, twice on the last stage (its forward unit runs no layer),
    B2, B3 (and B8) once; the faults are the three asked for."""
    want = cs.pp_launches(2, 3, moe=False, stage=0)
    assert want == {"flash_fwd": 36, "flash_bwd_dq": 12, "flash_bwd_dkv": 12, "moe_fwd": 0, "moe_bwd": 0}
    assert cs.pp_launches(2, 3, moe=False, stage=1) == dict(want, flash_fwd=24)
    moe = cs.pp_launches(2, 2, moe=True, stage=0)
    assert moe["flash_fwd"] == moe["moe_fwd"] == 24 and moe["flash_bwd_dq"] == moe["moe_bwd"] == 8
    last = cs.pp_launches(2, 2, moe=True, stage=1)
    assert last["flash_fwd"] == last["moe_fwd"] == 16 and last["flash_bwd_dq"] == last["moe_bwd"] == 8
    assert cs.PP_FAULTS == ("stale-residual", "short-schedule", "aux-unseeded")
    assert cs.PP_RUNS == ("llama-ok", "stale-residual", "short-schedule", "mixtral-ok", "aux-unseeded")


def test_pp_bytes_reckon_a_stages_part_of_the_tree():
    """Stage 0 holds half of each stacked layer leaf and the embedding, stage
    1 the other half and the final norm and head: together the whole tree,
    each leaf once."""
    import torch

    from tony_tpu_torch.models import llama

    cfg = llama.config_from_dict({"preset": "llama3-8b", "n_layers": 2})
    tree = llama.init(torch.Generator(), cfg, "meta")
    stages = [cs.pp_bytes(tree, s) for s in range(2)]
    assert sum(x["params"] for x in stages) == cfg.num_params()
    assert stages[0]["params"] - stages[1]["params"] == cfg.vocab_size * cfg.d_model - cfg.d_model - cfg.d_model * cfg.vocab_size
    assert stages[0]["acc_bytes"] == 4 * stages[0]["params"] and stages[0]["moment_bytes"] == 2 * stages[0]["param_bytes"]


def test_pp_phase_runs_last_in_main_and_reaches_the_report():
    src = (ROOT / "chip_smoke.py").read_text()
    main = src[src.index("def main() -> int:"):]
    assert main.index('phase("cp-tp")') < main.index('phase("pp")') < main.index("except SmokeFailure")
    assert 'more[k]["pp"] = pp["launches_sum"][k]' in main
    assert '"pp": pp' in main


def test_the_kernel_phases_hold_b1_b3_and_b7_b8_at_a_pp_microbatch():
    """``[pp]`` runs B1-B3 on one row of T=2048 at the Llama heads and B7/B8
    on 2048 tokens over all 8 experts at full F: a kernel case at each shape,
    held to the plain versions by the flash and MoE kernel phases."""
    assert cs.PP_B // cs.PP_M == cs.FLASH_CASES["pp"]["B"] == 1 and cs.FLASH_CASES["pp"]["T"] == cs.PP_T
    assert "pp" in cs.LLAMA_FLASH_CASES
    assert cs.MOE_CASES["pp"] == dict(tokens=cs.PP_B // cs.PP_M * cs.PP_T, skew="random")
