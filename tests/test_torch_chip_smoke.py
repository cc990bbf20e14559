"""chip_smoke.py off the card: it refuses to report without CUDA or without
the port beside it, its serving, text, options, deploy and pool phases rehearse
end to end on the CPU at a tiny size (the wrapper's plain version, no
kernel launches), its build phase's SASS census reads cuobjdump's listing
per instantiation, its tokenizer.json has Llama-3's layout, and its text
checks fail loudly when what they check is false."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import tokenizers
import torch

import chip_smoke
from modelx_tpu_torch.models import llama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    return subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_attention_bound_counts_visible_pairs():
    # the serving shape: causal, 2*B*H*S^2*D ~ 34 GFLOP at 989 TFLOP/s
    ms, by = chip_smoke.attention_bound(1, 32, 8, 2048, 128, True, 0, "bfloat16")
    assert by == "operations" and ms == pytest.approx(4 * 128 * 2048 * 2049 / 2 * 32 / 989e9)
    assert chip_smoke.visible_pairs(5, True, 2) == 1 + 2 + 2 + 2 + 2
    assert chip_smoke.visible_pairs(5, False, 2) == 25
    _, by = chip_smoke.attention_bound(2, 16, 4, 512, 64, True, 0, "bfloat16")
    assert by == "bytes"


def test_main_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024), rope_theta=500000.0)
    monkeypatch.setattr(chip_smoke, "FORWARD_SHAPES", ((1, 48), (2, 16)))
    monkeypatch.setattr(chip_smoke, "GENERATE_PROMPTS", (5, 12))
    monkeypatch.setattr(chip_smoke, "NEW_TOKENS", 3)
    monkeypatch.setattr(chip_smoke, "POOL_STREAM_PROMPT", 7)
    monkeypatch.setattr(chip_smoke, "POOL_STREAM_TOKENS", 400)  # in flight at the DELETE
    monkeypatch.setattr(chip_smoke, "POOL_VETO_LOADS", 3)
    # phases 7-10 on the shallower second checkpoint, as on the card
    monkeypatch.setattr(chip_smoke, "LATER_LAYERS", 1)
    monkeypatch.setattr(chip_smoke, "ART_BASE_LEN", 40)
    monkeypatch.setattr(chip_smoke, "ART_NEW_TOKENS", 4)
    # a tiny model streams fast: each engine chunk of the artifacts pods
    # waits 40 ms (an injected latency), so the router's poll sees the
    # drain while the hand-off stream still runs
    plan = tmp_path / "pace.json"
    plan.write_text(json.dumps({"seed": 0, "rules": [
        {"op": "engine.dispatch", "latency_at": list(range(5000)), "latency_s": 0.04}]}))
    monkeypatch.setattr(chip_smoke, "ART_POD_ENV", {"MODELX_FAULT_PLAN": f"@{plan}"})
    monkeypatch.setattr(chip_smoke, "ROUTER_STREAM_TOKENS", 64)
    monkeypatch.setattr(chip_smoke, "ROUTER_POLL_S", 0.05)
    monkeypatch.setattr(chip_smoke, "PROFILE_FORWARD", (1, 48))
    _tiny_options(monkeypatch)
    _tiny_continuous(monkeypatch)
    _tiny_lockdep(monkeypatch)
    stats = chip_smoke.phase_main(device="cpu", cfg=cfg)
    assert stats["flash_launches"] == 0  # CPU tensors take the plain version
    assert stats["logit_max_diff"] == 0.0 and stats["argmax_checked"] > 0
    assert {"forward_ms_1x48", "forward_ms_2x16", "generate_s_5", "generate_s_12"} <= set(stats)
    # the sampled and streamed phase ran its checks on the same server
    assert {"sampled_tokens_per_s_5", "stream_first_line_ms_12",
            "prefix_first_line_ms_warm"} <= set(stats)
    assert stats["overflow_sort_steps"] > 0
    # the observability surface on the same server: /metrics counted the
    # POSTs, the request id sliced /v1/trace, the profile wrote a trace
    # (CPU ops only: no kernel events here), 4 captures kept, one access-log
    # line per POST
    assert stats["obs_profile_flash_events"] == 0 and stats["obs_trace_bytes"] > 0
    assert len(stats["obs_profile_forward_ms"]) == 2 and stats["obs_span_us"] > 0
    assert {"obs_profile_s", "obs_admin_profiles_s", "obs_capture_bytes"} <= set(stats)
    # and the text phase, on its own count
    assert stats["flash_launches_text"] == 0 and stats["score_max_diff"] == 0.0
    assert {"tokenizer_load_ms", "encode_tokens_per_s", "chat_s", "sse_first_content_ms",
            "score_ms"} <= set(stats)
    # and the options phase, on its own count: the burst coalesced, int8 and
    # LoRA served, speculation ran
    assert stats["flash_launches_options"] == 0
    assert stats["batch_device_calls"] < stats["batch_requests"] == 7
    assert stats["spec_steps"] > 0 and stats["int8_device_gb"] > 0
    assert stats["int8_linear_max_abs_err"] >= 0 and stats["lora_merge_s"] >= 0
    assert stats["later_layers"] == 1 < cfg.num_layers
    # and the registry deploy, on its own count: cold and warm modelxdl-torch,
    # cold and warm TTFT in child processes, the pulled dest served
    assert stats["flash_launches_deploy"] == 0
    assert {"deploy_cold_gbps", "deploy_warm_gbps", "deploy_cold_pull_s",
            "sha256_s_registry_write", "sha256_s_dest_verify", "ttft_cold_ttft_ms",
            "ttft_warm_ttft_ms", "ttft_warm_weights_ready_ms"} <= set(stats)
    # and the derived-artifact stores, on their own count (the two pods'):
    # pod A published the (stand-in) library and the hot prefix's KV, pod B
    # installed both at its load, answered pod A's bytes from the installed
    # prefix and fetched the second prefix through
    assert stats["flash_launches_artifacts"] == 0
    assert stats["art_kv_stored_len"] == 48 and stats["art_hits_installed"] >= 1
    assert stats["art_installed_admits"] >= 1 and stats["art_nvcc_s"] is None
    assert {"art_program_bytes", "art_program_publish_s", "art_kv_bytes", "art_kv_build_ms",
            "art_kv_publish_s", "art_load_b_s", "art_ready_b_s", "art_program_install_ms",
            "art_kv_install_ms", "art_ttft_installed_ms", "art_ttft_cold_ms",
            "art_fetch_install_ms", "art_outbox_depth", "art_phase_s"} <= set(stats)
    # and the fleet router in front of the two pods, on its own count: the
    # routed bytes equal the direct ones, the drain hand-off was continued
    assert stats["flash_launches_router"] == 0
    assert 0 < stats["router_handoff_step"] < chip_smoke.ROUTER_STREAM_TOKENS
    assert {"router_healthz_s", "router_ready_s", "router_forward_ms", "direct_forward_ms",
            "router_hop_ms", "router_handoff_gap_ms", "router_handoff_held",
            "router_path_s"} <= set(stats)
    # and the model pool, on its own count: admin loads while serving, the
    # eviction into the host tier, promotion from host and from disk, the
    # drain of one model and of a SIGTERM'd child pod, and the veto loads
    # (no card: no device accounting, so every load is admitted)
    assert stats["flash_launches_pool"] == 0
    assert {"pool_cold_load_s", "pool_demote_ms", "pool_promote_host_gbps", "pool_spool_gbps",
            "pool_unspool_ms", "pool_promote_disk_s", "pool_drain_s", "pod_drain_s",
            "pool_forward_lone_ms"} <= set(stats)
    # every name loads one checkpoint, so one content key: c and the
    # re-POSTed a both promote from the host tier, the last reload from disk
    assert stats["pool_tiers"]["disk"]["hits"] == 1 and stats["pool_tiers"]["host"]["hits"] == 2
    assert stats["pool_c_load_source"] == "tier"
    assert stats["pool_veto_outcome"] == "none" and stats["pool_veto_loaded"] == 3
    assert all(r["source"] == "none" for r in stats["pool_veto_rows"])
    # and the continuous engine, on its own count: the mixed traffic through
    # a serve_main child, resume, 504 and 429, dense == gather, in-place,
    # chunked prefill with and without, speculation, and every figure the
    # kernels line and PERF.md take
    assert stats["flash_launches_continuous"] == 0
    assert stats["cont_shed"] >= 1 and stats["cont_resume"]
    assert {"cont_plain_tps", "cont_batcher_tps", "cont_tps_engine", "cont_tps_engine_whole",
            "cont_ttft_ms_p50", "cont_ttft_ms_p99", "cont_ttft_ms_late",
            "cont_forward_ms_decoding", "cont_forward_ms_alone", "cont_tps_dense",
            "cont_tps_gather", "cont_tps_in-place", "cont_fill_gap_ms_chunked",
            "cont_fill_gap_ms_monolithic", "cont_boundary_host_ms_p50_dense"} <= set(stats)
    assert stats["cont_kv_bytes_gather"] < stats["cont_kv_bytes_dense"]
    assert stats["cont_syncs_per_boundary_dense"] <= 1
    assert stats["cont_spec_accept_rate"] >= chip_smoke.CONT_SPEC_MIN_RATE
    # and the lockdep phase after pool, on the same dest, on its own count:
    # the lint gate clean, the pod's graph without a cycle, the /v1/forward
    # argmax the later checkpoint's own serving gave
    assert stats["flash_launches_lockdep"] == 0 and stats["lockdep_cycles"] == 0
    assert "0 new finding(s)" in stats["lint_summary"]
    assert stats["lockdep_classes"] > 10 and stats["lockdep_edges"] >= 1
    assert {"lockdep_boot_s", "lockdep_forward_ms", "lockdep_clients_s", "lockdep_admin_s",
            "lockdep_drain_s", "lockdep_longest_hold_ms", "lockdep_phase_s"} <= set(stats)


def _tiny_lockdep(monkeypatch):
    for name, value in (("LOCKDEP_FORWARD", (1, 48)), ("LOCKDEP_PROMPT", 12),
                        ("LOCKDEP_NEW_TOKENS", 3), ("LOCKDEP_DRAIN_TOKENS", 200)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_lockdep_phase_rehearses_alone_on_cpu(monkeypatch):
    """``--phases lockdep`` alone: the later checkpoint written by the phase,
    the lint gate, the pod under the port's lockdep (the server's device
    lock and the pool's lock among its classes), no cycle, the factories
    restored after."""
    import threading

    from modelx_tpu_torch.analysis import lockdep

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024), rope_theta=500000.0)
    monkeypatch.setattr(chip_smoke, "LATER_LAYERS", 1)
    _tiny_lockdep(monkeypatch)
    real = threading.Lock
    stats = chip_smoke.lockdep_alone(device="cpu", cfg=cfg)
    assert threading.Lock is real and not lockdep.owns_factories()
    assert stats["lockdep_cycles"] == 0 and stats["flash_launches_lockdep"] == 0
    assert "0 new finding(s)" in stats["lint_summary"]
    assert stats["lockdep_acquisitions"] > 100


def test_lockdep_report_fails_on_a_cycle_and_names_holds():
    from modelx_tpu_torch.analysis import lockdep

    graph = lockdep.LockGraph(hold_threshold_ms=1.0)
    a = lockdep.make_lock(graph, site=os.path.join(chip_smoke.REPO, "x.py") + ":1")
    b = lockdep.make_lock(graph, site="y.py:2")
    with a:
        time.sleep(0.005)
        with b:
            pass
    out = chip_smoke.lockdep_report(graph)
    assert out["lockdep_cycles"] == 0 and out["lockdep_longest_hold_site"] == "x.py:1"
    assert out["lockdep_long_holds"][0]["count"] == 1
    with b:
        with a:
            pass
    with pytest.raises(RuntimeError, match="lock-order cycle"):
        chip_smoke.lockdep_report(graph)


def _tiny_families():
    """family_configs at the JAX tiny presets, each as config inference
    reads it back (mixtral at inference's rope theta)."""
    from modelx_tpu_torch.models import bert, gemma2, gpt2, mixtral

    return [("gemma2", gemma2.Gemma2Config.tiny(vocab_size=256)),
            # 1024 ids: the padded tokenizer.json's 256 specials and its bytes
            ("phi3", dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024),
                                         dtype=torch.bfloat16)),
            ("mixtral", dataclasses.replace(mixtral.MixtralConfig.tiny(vocab_size=256),
                                            rope_theta=1e6)),
            ("gpt2", dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.bfloat16)),
            ("bert", bert.BertConfig.tiny())]


def test_family_configs_take_the_depth_cuts():
    """The full-width presets the card runs, at the depths the time limit
    allows (the CPU rehearsal passes its own tiny configs)."""
    cfgs = dict(chip_smoke.family_configs())
    assert list(cfgs) == ["gemma2", "phi3", "mixtral", "gpt2", "bert"]
    assert cfgs["gemma2"].num_layers == chip_smoke.GEMMA_LAYERS
    assert cfgs["phi3"].num_layers == chip_smoke.PHI3_LAYERS and cfgs["phi3"].head_dim == 96
    assert cfgs["mixtral"].num_layers == chip_smoke.MIXTRAL_LAYERS
    assert cfgs["gpt2"].num_layers == 12 and cfgs["bert"].num_layers == 12


def test_families_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10 at the tiny presets: gemma2's long forward and decode cut
    past its 16-key window, the engines run, gpt2 answers its 400s."""
    for name, value in (("FAMILY_FORWARD_LEN", 48), ("FAMILY_PROMPT", 12), ("FAMILY_NEW", 4),
                        ("GEMMA_LONG_FORWARD", 40), ("GEMMA_LONG_PROMPT", 30),
                        ("GEMMA_LONG_NEW", 4), ("GEMMA_ENGINE_PROMPTS", (5, 12, 20, 5)),
                        ("GEMMA_PAGE_SIZE", 16), ("CONT_MAX_LEN", 64), ("CONT_CHUNK", 2),
                        ("BERT_FORWARD_SHAPES", ((1, 48), (3, 64))), ("BERT_CHECK_LEN", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    stats = chip_smoke.phase_families(device="cpu", configs=_tiny_families())
    assert stats["flash_launches_families"] == 0  # CPU tensors take the plain version
    for name in ("gemma2", "phi3", "mixtral", "gpt2"):
        assert stats[f"fam_{name}_launches"] == 0
        assert {f"fam_{name}_load_gbps", f"fam_{name}_forward_ms",
                f"fam_{name}_greedy_tps"} <= set(stats)
    assert {"fam_gemma2_long_forward_ms", "fam_gemma2_engine_tps", "fam_gemma2_tps_gather",
            "fam_gemma2_tps_in-place", "fam_phi3_int8_forward_ms"} <= set(stats)
    # the families' tokenizer.json files: Unigram + Precompiled with a
    # truncation (gemma2), Digits + Punctuation with padding (phi3)
    assert {"fam_gemma2_tokenizer_load_ms", "fam_gemma2_encode_tokens_per_s",
            "fam_gemma2_logprobs_s", "fam_gemma2_text_s", "fam_phi3_tokenizer_load_ms",
            "fam_phi3_text_s"} <= set(stats)
    assert stats["fam_phi3_padded_ids"] % 8 == 0
    # bert: forwards only, no kernel, the CPU's features against themselves
    assert stats["fam_bert_launches"] == 0 and stats["fam_bert_feature_err"] == 0.0
    assert {"fam_bert_forward_ms_1x48", "fam_bert_forward_ms_3x64", "fam_bert_write_s",
            "fam_bert_bytes", "fam_bert_load_gbps"} <= set(stats)
    # the objectstore path on the tiny phi3: pushed through the fake bucket
    # by the CLI, pulled back by modelxdl-torch with native reads, served
    assert stats["flash_launches_objectstore"] == 0
    assert stats["obj_parts"] == 1 and stats["obj_presign_issued"] >= 2
    assert stats["obj_native_reads"] > 0 and stats["obj_ranged_gets"] > 0
    assert {"obj_push_gbps", "obj_pull_gbps", "obj_hash_native_gbps", "obj_hash_hashlib_gbps",
            "obj_forward_ms", "obj_scrub_s", "obj_path_s"} <= set(stats)


def test_prometheus_check_takes_the_exposition_and_rejects_a_torn_line():
    from modelx_tpu_torch.utils import promexp

    text = promexp.render({"m": {"requests": 3, "queue_ms_hist": promexp.Histogram().snapshot(),
                                 "state": "READY"}, "device": {"devices": {"0": {"x": 1.5}}}},
                          label_levels={("*",): "model", ("*", "devices", "*"): "device"})
    assert chip_smoke.check_prometheus(text) == 1 + 15 + 2 + 1
    assert chip_smoke.check_prometheus('modelx_a{model="q\\"uote"} +Inf\n') == 1
    for bad in ("modelx_a 1 2", 'modelx_a{model="x} 1', "modelx_a", "# COMMENT x"):
        with pytest.raises(RuntimeError, match="unparseable"):
            chip_smoke.check_prometheus(bad)


def test_trace_kernels_counts_kernel_events(tmp_path):
    events = [{"cat": "kernel", "name": "void flash_fwd_bf16<128>(Params)"},
              {"cat": "kernel", "name": "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNN"},
              {"cat": "kernel", "name": "void flash_fwd_bf16<128>(Params)"},
              {"cat": "cpu_op", "name": "aten::mm"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    kernels = chip_smoke.trace_kernels(str(path))
    assert kernels == {"void flash_fwd_bf16<128>(Params)": 2,
                       "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNN": 1}
    assert all(chip_smoke.GEMM_NAME.search(n) for n in (
        "nvjet_hsh_128x256", "sm90_xmma_gemm_bf16bf16", "cutlass_80_tensorop_gemm"))


def test_hf_expert_layout_is_what_the_loader_folds_back(tmp_path):
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.loader import LocalFileSource, load_safetensors
    from modelx_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.tiny(vocab_size=64)
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0))
    written = chip_smoke.hf_expert_layout(params)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in written
    assert not any(n.endswith("experts.w1.weight") for n in written)
    path = str(tmp_path / "model.safetensors")
    st.write_safetensors(path, written)
    loaded, _ = load_safetensors(LocalFileSource(path), "cpu")
    assert loaded.keys() == params.keys()
    assert all(torch.equal(loaded[n], params[n]) for n in params)


def _tiny_options(monkeypatch):
    """The options phase's shapes cut to the tiny CPU model."""
    for name, value in (("BATCH_FORWARD_SHAPES", ((1, 12), (2, 30), (1, 5), (3, 9))),
                        ("BATCH_GREEDY_PROMPTS", (6, 20)),
                        ("BATCH_SAMPLED", ((9, {"temperature": 0.8, "seed": 21}),)),
                        ("BATCH_NEW_TOKENS", 4), ("BATCH_WINDOW_MS", 500.0),
                        ("SPEC_PERIOD", 5), ("SPEC_REPEATS", 4), ("SPEC_NEW_TOKENS", 12),
                        ("INT8_FORWARD", (1, 40)), ("INT8_PROMPT", 8), ("INT8_NEW_TOKENS", 4)):
        monkeypatch.setattr(chip_smoke, name, value)


def _tiny_continuous(monkeypatch):
    """The continuous phase's shapes cut to the tiny CPU model: short
    prompts, 2-token chunks so the decode rows outlast the fill's pieces."""
    for name, value in (("CONT_PROMPTS", (5, 12, 40, 5, 12, 40, 5, 12)),
                        ("CONT_NEW_TOKENS", 16), ("CONT_LATE_AFTER", 2), ("CONT_CHUNK", 2),
                        ("CONT_MAX_LEN", 128), ("KV_LIVE_TOKENS", 1024), ("PREFILL_CHUNK", 16),
                        ("RESUME_AFTER", 3)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_attention_flops_is_what_the_bound_divides():
    flops = chip_smoke.attention_flops(1, 32, 2048, 128, True, 0)
    assert flops == 4 * 128 * (2048 * 2049 // 2) * 32
    ms, by = chip_smoke.attention_bound(1, 32, 8, 2048, 128, True, 0, "bfloat16")
    assert by == "operations" and ms == pytest.approx(flops / chip_smoke.PEAK_FLOPS["bfloat16"] * 1e3)
    assert chip_smoke.attention_flops(1, 1, 5, 64, True, 2) == 4 * 64 * 9


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114flash_fwd_bf16ILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiffii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0040*/              @P0  HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR12], R88, gsb0 ;
\t\tFunction : _ZN12_GLOBAL__N_113flash_fwd_f32ILi64EEEvPKfS2_S2_Pfiiiiffii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
"""


def test_sass_census_counts_per_instantiation():
    census = chip_smoke.sass_census(SASS)
    assert census == {
        "flash_fwd_bf16<128>": {"HGMMA": 3, "HMMA": 0, "UTMALDG": 1, "LDGSTS": 0},
        "flash_fwd_f32<64>": {"HGMMA": 0, "HMMA": 1, "UTMALDG": 0, "LDGSTS": 1},
    }


def test_kernel_label_names_typed_and_training_instantiations():
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi128ELb1EEEvv") == "flash_fwd_bf16<128,lse>"
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi128ELb0EEEvv") == "flash_fwd_bf16<128>"
    assert chip_smoke.kernel_label(
        "_ZN55_GLOBAL__N__b15ab8b7_22_flash_attention_bwd_cu_4dbe314f18flash_bwd_dkdv_mmaILi96E"
        "EEvPK13__nv_bfloat16") == "flash_bwd_dkdv_mma<96>"
    assert chip_smoke.kernel_label(
        "_ZN12_GLOBAL__N_114flash_fwd_simtI13__nv_bfloat16Li32EEEvPKT_") == "flash_fwd_simt<bf16,32>"
    # the training forward's own translation unit (flash_attention_lse.cu)
    assert chip_smoke.kernel_label(
        "_ZN55_GLOBAL__N__0a1b2c3d_22_flash_attention_lse_cu_5e6f7a8b14flash_fwd_bf16ILi96ELb1E"
        "EEvv") == "flash_fwd_bf16<96,lse>"


def test_kernel_label_names_the_backwards_kernels():
    # the wgmma kernel's per-head-dim translation units, the pre-pass, and
    # the post-pass, which is no template
    assert chip_smoke.kernel_label(
        "_ZN64_GLOBAL__N__a3707b9c_27_flash_attention_bwd_d128_cu_c85dfa13_17115flash_bwd_wgmma"
        "ILi128EEEv14CUtensorMap_stS1_S1_S1_N2mx7BwdArgsE") == "flash_bwd_wgmma<128>"
    assert chip_smoke.kernel_label(
        "_ZN63_GLOBAL__N__d5ab1f7c_26_flash_attention_bwd_d96_cu_c85dfa13_17715flash_bwd_wgmma"
        "ILi96EEEv14CUtensorMap_stS1_S1_S1_N2mx7BwdArgsE") == "flash_bwd_wgmma<96>"
    assert chip_smoke.kernel_label(
        "_ZN55_GLOBAL__N__b15ab8b7_22_flash_attention_bwd_cu_4dbe314f14flash_bwd_prepILi64EEEvPK"
        "13__nv_bfloat16S3_PKfPfS6_S6_P6float4iixx") == "flash_bwd_prep<64>"
    assert chip_smoke.kernel_label(
        "_ZN55_GLOBAL__N__b15ab8b7_22_flash_attention_bwd_cu_4dbe314f16flash_bwd_finishEPK6float4P5"
        "uint2xS2_S2_S4_S4_xf") == "flash_bwd_finish"


def _census(**overrides):
    """A census of every instantiation check_census reads, each with the
    instructions it should have; ``overrides`` replace entries by label."""
    from modelx_tpu_torch.ops.attention import BACKWARD_WGMMA_HEAD_DIMS, KERNEL_HEAD_DIMS

    ops = dict.fromkeys(chip_smoke.SASS_OPS, 0)
    census = {f"flash_fwd_bf16<{d}>": {**ops, "HGMMA": 8, "UTMALDG": 4}
              for d in KERNEL_HEAD_DIMS if d != 32}
    census.update({f"flash_bwd_wgmma<{d}>": {**ops, "HGMMA": 40, "UTMALDG": 6}
                   for d in BACKWARD_WGMMA_HEAD_DIMS})
    census.update({f"flash_bwd_{p}_mma<32>": {**ops, "HMMA": 64} for p in ("dkdv", "dq")})
    census.update({"flash_bwd_dkdv<128>": dict(ops), "flash_bwd_prep<128>": dict(ops)})
    census.update(overrides)
    return census


def test_census_gate_takes_the_tensor_core_kernels():
    chip_smoke.check_census(_census())


@pytest.mark.parametrize("label,counts,match", [
    ("flash_bwd_wgmma<96>", {"HGMMA": 0, "UTMALDG": 6}, r"flash_bwd_wgmma<96> HGMMA"),
    ("flash_bwd_wgmma<128>", {"HGMMA": 40, "UTMALDG": 0}, r"flash_bwd_wgmma<128> UTMALDG"),
    ("flash_bwd_wgmma<64>", {"HGMMA": 40, "UTMALDG": 6, "HMMA": 2}, r"mma.sync .*wgmma<64>"),
    ("flash_bwd_dkdv_mma<64>", {"HMMA": 64}, r"mma.sync .*dkdv_mma<64>"),
    ("flash_bwd_dq_mma<32>", {"HMMA": 0}, r"flash_bwd_dq_mma<32> HMMA"),
    ("flash_fwd_bf16<128>", {"HGMMA": 0}, r"flash_fwd_bf16<128> HGMMA"),
])
def test_census_gate_fails_off_the_tensor_cores(label, counts, match):
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.check_census(_census(**{label: {**dict.fromkeys(chip_smoke.SASS_OPS, 0),
                                                   **counts}}))


def test_census_gate_fails_on_a_sass_dump_without_hgmma_in_the_backward():
    """cuobjdump's listing of a bf16 backward instantiation that runs no
    warpgroup MMA (a mma.sync build of it) fails the build phase."""
    sass = """
\t\tFunction : _ZN64_GLOBAL__N__a3707b9c_27_flash_attention_bwd_d128_cu_c85dfa13_17115flash_bwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_N2mx7BwdArgsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    dumped = chip_smoke.sass_census(sass)
    assert dumped["flash_bwd_wgmma<128>"]["HGMMA"] == 0
    census = _census()
    census.update(dumped)
    with pytest.raises(RuntimeError, match=r"flash_bwd_wgmma<128> HGMMA"):
        chip_smoke.check_census(census)


def test_ptxas_report_reads_registers_and_spills():
    log = """== flash_attention_bwd_d128.cu
ptxas info    : Compiling entry function '_ZN64_GLOBAL__N__a3707b9c_27_flash_attention_bwd_d128_cu_c85dfa13_17115flash_bwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_N2mx7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN64_GLOBAL__N__a3707b9c_27_flash_attention_bwd_d128_cu_c85dfa13_17115flash_bwd_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_N2mx7BwdArgsE
    56 bytes stack frame, 56 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__b15ab8b7_22_flash_attention_bwd_cu_4dbe314f16flash_bwd_finishEPK6float4P5uint2xS2_S2_S4_S4_xf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers
"""
    assert chip_smoke.ptxas_report(log) == {
        "flash_bwd_wgmma<128>": {"registers": 168, "spill_stores": 56, "spill_loads": 68},
        "flash_bwd_finish": {"registers": 22, "spill_stores": 0, "spill_loads": 0},
    }


def test_kernel_label_leaves_foreign_names_alone():
    assert chip_smoke.kernel_label("_Z6kernelv") == "_Z6kernelv"
    assert chip_smoke.kernel_label("_ZN12_GLOBAL__N_114flash_fwd_bf16ILi256EEEv") == "flash_fwd_bf16<256>"


def test_sass_census_is_not_available_without_cuobjdump(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("")
    assert chip_smoke.dump_sass(str(nvcc), str(tmp_path / "lib.so")) is None


@pytest.fixture(scope="module")
def tiny_server(tmp_path_factory):
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl.serve import ModelServer

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256), rope_theta=500000.0)
    d = tmp_path_factory.mktemp("tiny")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    st.write_safetensors(str(d / "model.safetensors"), params)
    server = ModelServer(str(d), dtype="float32", device="cpu")
    server.load()
    return server


def test_greedy_replay_is_the_servers_greedy_decode(tiny_server):
    prompt = list(range(3, 23))
    want = tiny_server.generate(np.asarray([prompt], np.int32), max_new_tokens=5)[0, 20:]
    picks, logits = chip_smoke._replay_step_logits(tiny_server, prompt, want.tolist())
    assert picks == want.tolist()
    assert logits.shape == (5, 256) and logits.argmax(-1).tolist() == picks
    # forcing other tokens: each step's logits come from the forced prefix
    forced = [(t + 1) % 256 for t in want.tolist()]
    picks, logits = chip_smoke._replay_step_logits(tiny_server, prompt, forced)
    assert picks[0] == want[0] and logits.argmax(-1).tolist() == picks
    fresh = tiny_server.generate(np.asarray([prompt + forced[:2]], np.int32), 1)[0, -1]
    assert picks[2] == fresh


def test_top1_check_allows_only_a_tied_maximum(tiny_server, monkeypatch):
    prompt = list(range(3, 23))
    greedy = tiny_server.generate(np.asarray([prompt], np.int32), max_new_tokens=4)[0, 20:]
    greedy = greedy.tolist()
    assert chip_smoke._check_top1(tiny_server, prompt, greedy, greedy) == "top_k 1 == greedy"
    other = (greedy[1] + 1) % 256
    drawn = [greedy[0], other, 9, 10]
    # the replay on top_k 1's own path: greedy's picks there, one-hot logits
    picks = [greedy[0], greedy[1], 9, 11]
    logits = torch.zeros((4, 256))
    logits[torch.arange(4), torch.tensor(picks)] = 1.0
    monkeypatch.setattr(chip_smoke, "_replay_step_logits", lambda *a: (picks, logits))
    with pytest.raises(RuntimeError, match="below the maximum"):
        chip_smoke._check_top1(tiny_server, prompt, greedy, drawn)
    logits[1, other] = 1.0  # now the maximum at step 1 is tied
    with pytest.raises(RuntimeError, match="at step 3"):  # a later miss still fails
        chip_smoke._check_top1(tiny_server, prompt, greedy, drawn)
    logits[3, 10] = 1.0
    assert "up to step 1" in chip_smoke._check_top1(tiny_server, prompt, greedy, drawn)
    with pytest.raises(RuntimeError, match="replay differs"):
        chip_smoke._check_top1(tiny_server, prompt, [greedy[0] + 1] + greedy[1:], drawn)


def test_smoke_tokenizer_writer_has_llama3_layout(tmp_path):
    """The written tokenizer.json loads in tokenizers with Llama-3's
    components, its special tokens at ids vocab..vocab+255, and merges that
    make the smoke's English words single tokens; tokenizer_config.json
    carries the chat template."""
    chip_smoke.write_text_files(str(tmp_path), vocab_size=3000)
    ref = tokenizers.Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    split, byte_level = spec["pre_tokenizer"]["pretokenizers"]
    assert split == {"type": "Split", "pattern": {"Regex": chip_smoke.LLAMA3_PATTERN},
                     "behavior": "Isolated", "invert": False}
    assert byte_level["type"] == "ByteLevel" and byte_level["use_regex"] is False
    assert spec["model"]["ignore_merges"] is True and spec["decoder"]["type"] == "ByteLevel"
    assert ref.get_vocab_size(with_added_tokens=False) == 3000
    specials = {t["content"]: t["id"] for t in spec["added_tokens"]}
    assert sorted(specials.values()) == list(range(3000, 3256))
    assert all(t["special"] and not t["normalized"] for t in spec["added_tokens"])
    for name, offset in (("<|begin_of_text|>", 0), ("<|end_of_text|>", 1),
                         ("<|start_header_id|>", 6), ("<|end_header_id|>", 7),
                         ("<|eot_id|>", 9)):
        assert specials[name] == 3000 + offset
    ids = ref.encode(chip_smoke.TEXT_PROMPT).ids
    assert ids[0] == 3000
    assert len(ids) < 2 * len(chip_smoke.TEXT_PROMPT.split())  # merges apply
    assert ref.decode(ids[1:]) == chip_smoke.TEXT_PROMPT
    cfg = json.loads((tmp_path / "tokenizer_config.json").read_text())
    assert cfg["chat_template"] == chip_smoke.LLAMA3_CHAT_TEMPLATE
    # the full file: 128,000 regular tokens, deterministic
    full = chip_smoke.llama3_tokenizer_json()
    assert len(json.loads(full)["model"]["vocab"]) == 128000
    assert full == chip_smoke.llama3_tokenizer_json()


@pytest.mark.parametrize("name,vocab", sorted(chip_smoke.FAMILY_TEXT_DIGESTS))
def test_family_tokenizer_digests_are_the_tokenizers_packages(name, vocab):
    """The digests the card's host holds its ids to are the ``tokenizers``
    package's ids for the same files (and the port's, here)."""
    from modelx_tpu_torch.dl.tokenizer import Tokenizer

    text = chip_smoke.FAMILY_TOKENIZERS[name](vocab)
    ref = tokenizers.Tokenizer.from_str(text)
    want = chip_smoke.FAMILY_TEXT_DIGESTS[(name, vocab)]
    assert chip_smoke.family_ids_digest(lambda t: ref.encode(t).ids) == want
    assert chip_smoke.family_ids_digest(Tokenizer.from_str(text).encode) == want
    spec = json.loads(text)
    assert ref.get_vocab_size(with_added_tokens=True) == vocab
    if name == "gemma2":
        assert spec["model"]["type"] == "Unigram" and len(spec["model"]["vocab"]) == vocab
        assert [n["type"] for n in spec["normalizer"]["normalizers"]] == ["Precompiled",
                                                                         "Replace"]
        assert spec["truncation"]["max_length"] == chip_smoke.GEMMA_TRUNCATE
        assert len(ref.encode(chip_smoke.FAMILY_TEXT_PROMPT).ids) == chip_smoke.GEMMA_TRUNCATE
    else:
        assert spec["padding"]["pad_to_multiple_of"] == 8
        assert len(ref.encode(chip_smoke.FAMILY_TEXT_PROMPT).ids) % 8 == 0


@pytest.fixture(scope="module")
def text_pod(tmp_path_factory):
    from modelx_tpu_torch.dl import safetensors as st
    from modelx_tpu_torch.dl import serve_main
    from modelx_tpu.registry.server import free_port

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024), rope_theta=500000.0)
    d = tmp_path_factory.mktemp("tiny-text")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    st.write_safetensors(str(d / "model.safetensors"), params)
    chip_smoke.write_text_files(str(d), cfg.vocab_size - 256)
    port = free_port()
    sset, httpd = serve_main.start(["--model", f"m={d}", "--device", "cpu", "--dtype",
                                    "float32", "--listen", f"127.0.0.1:{port}"])
    yield port, sset.servers["m"], cfg
    httpd.shutdown()
    httpd.server_close()


def test_text_phase_passes_on_cpu(text_pod):
    port, server, cfg = text_pod
    stats = chip_smoke.phase_text(port, server, cfg, per_forward=0)
    assert stats["score_max_diff"] == 0.0 and stats["chat_s"] > 0


def test_text_phase_fails_when_the_kernel_is_not_launched(text_pod):
    port, server, cfg = text_pod
    with pytest.raises(RuntimeError, match="launched 0 times, want 2"):
        chip_smoke.phase_text(port, server, cfg, per_forward=2)


def test_chat_check_fails_on_a_fallback_or_a_foreign_template(text_pod, monkeypatch):
    _, server, _ = text_pod
    assert chip_smoke.check_chat_prompt(server, chip_smoke.CHAT_MESSAGES)
    spec = server.chat_template()
    monkeypatch.setattr(server, "chat_template", lambda: None)  # e.g. no jinja2
    with pytest.raises(RuntimeError, match="did not load"):
        chip_smoke.check_chat_prompt(server, chip_smoke.CHAT_MESSAGES)
    import jinja2

    plain = dict(spec, compiled=jinja2.Template("{% for m in messages %}{{ m.content }}"
                                                "{% endfor %}"))
    monkeypatch.setattr(server, "chat_template", lambda: plain)
    with pytest.raises(RuntimeError, match="no <\\|start_header_id\\|>"):
        chip_smoke.check_chat_prompt(server, chip_smoke.CHAT_MESSAGES)


def test_sse_check_fails_on_a_lost_delta():
    role = {"choices": [{"index": 0, "delta": {"role": "assistant"}, "finish_reason": None}]}
    deltas = [{"choices": [{"index": 0, "delta": {"content": c}, "finish_reason": None}]}
              for c in ("a", "b", "c")]
    end = {"choices": [{"index": 0, "delta": {}, "finish_reason": "length"}]}
    assert chip_smoke.check_sse_deltas([role, *deltas, end], "abc", chat=True) == "abc"
    with pytest.raises(RuntimeError, match="differ from the whole answer"):
        chip_smoke.check_sse_deltas([role, deltas[0], deltas[2], end], "abc", chat=True)
    with pytest.raises(RuntimeError, match="role chunk"):
        chip_smoke.check_sse_deltas([*deltas, end], "abc", chat=True)
    with pytest.raises(RuntimeError, match="ended with"):
        chip_smoke.check_sse_deltas([role, *deltas], "abc", chat=True)


def test_options_batch_fails_on_a_broken_batched_answer(text_pod, monkeypatch):
    from modelx_tpu_torch.dl.serve import Batcher

    port, server, cfg = text_pod
    _tiny_options(monkeypatch)
    pack = Batcher._pack

    def shifted(rows):  # every batched row answers for other tokens
        batch, spans = pack(rows)
        return (batch + 1) % cfg.vocab_size, spans

    monkeypatch.setattr(Batcher, "_pack", staticmethod(shifted))
    with pytest.raises(RuntimeError, match="below the maximum"):
        chip_smoke.options_batch(port, server, cfg, per_forward=0)


def test_options_batch_fails_when_nothing_coalesces(text_pod, monkeypatch):
    port, server, cfg = text_pod
    _tiny_options(monkeypatch)
    monkeypatch.setattr(chip_smoke, "BATCH_WINDOW_MS", 0.0)
    with pytest.raises(RuntimeError, match="did not coalesce"):
        chip_smoke.options_batch(port, server, cfg, per_forward=0)


def test_near_tie_check_reads_the_requests_own_noise(tiny_server):
    """A sampled answer that differs from the lone one passes only where the
    replay's Gumbel-perturbed logits put its token near the maximum."""
    prompt = list(range(3, 23))
    samp = {"temperature": 0.8, "seed": 21}
    lone = tiny_server.generate(np.asarray([prompt], np.int32), max_new_tokens=5,
                                **samp)[0, 20:].tolist()
    assert chip_smoke.check_near_ties(tiny_server, prompt, lone, lone, "x", samp) == "equal"
    other = lone[:3] + [(lone[3] + 1) % 256, lone[4]]
    with pytest.raises(RuntimeError, match="below the maximum"):
        chip_smoke.check_near_ties(tiny_server, prompt, other, lone, "x", samp)
    with pytest.raises(RuntimeError, match="replay differs"):  # the wrong seed's noise
        chip_smoke.check_near_ties(tiny_server, prompt, other, lone, "x",
                                   {"temperature": 0.8, "seed": 22})


def test_objectstore_bucket_child_logs_and_lists_parts(tmp_path):
    """The objectstore path's bucket child (tests/fake_s3.py behind a
    logging handler): every request lands in its log, and ListParts gives
    the fake's own ETags (each part's MD5) from the MD5s kept at PUT."""
    import hashlib
    import time

    import requests

    from modelx_tpu_torch.registry.fs_s3 import S3Client, S3Options

    log_path = tmp_path / "s3.jsonl"
    proc = subprocess.Popen([sys.executable, "-u", "-c", chip_smoke.FAKE_S3_CHILD, str(log_path)],
                            cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        url = proc.stdout.readline().strip()
        client = S3Client(S3Options(url=url, access_key="a", secret_key="s", bucket="b"))
        upload_id = client.create_multipart_upload("k")
        parts = [b"x" * 1000, b"y" * 10, b"z" * 77]
        for i, data in enumerate(parts, start=1):
            put = client.presign("PUT", "k", query={"partNumber": str(i), "uploadId": upload_id})
            assert requests.put(put, data=data).status_code == 200
        time.sleep(0.2)
        assert client.list_parts("k", upload_id) == [
            (i, hashlib.md5(d).hexdigest(), len(d)) for i, d in enumerate(parts, start=1)]
        client.complete_multipart_upload("k", upload_id, [
            (n, e) for n, e, _ in client.list_parts("k", upload_id)])
        assert client.get_object("k").content == b"".join(parts)
        recs = [json.loads(line) for line in open(log_path)]
        puts = [r for r in recs if r["m"] == "PUT" and r["key"] == "k"]
        assert [r["bytes"] for r in puts] == [1000, 10, 77]
        assert all(r["presigned"] and "partNumber" in r["q"] for r in puts)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_the_handoff_check_takes_only_a_near_tie():
    """The router path's verdict: a spliced stream equal to the
    uninterrupted one holds; one that differs holds only where the top-2
    margin on the common prefix and both tokens' distance below the
    maximum are within MARGIN_TOL; a byte of the tail that is not the
    second pod's fails."""
    whole = [5, 6, 7, 8, 9, 10]
    got = [5, 6, 7, 8, 11, 12]
    tol = chip_smoke.MARGIN_TOL
    assert chip_smoke.check_handoff(whole, whole, 2, whole[2:], True, None).startswith("equal")
    held = chip_smoke.check_handoff(got, whole, 3, got[3:], True,
                                    lambda j: (tol / 4, {11: 0.0, 9: tol / 2}))
    assert "step 4 (11 vs 9)" in held and "near tie" in held
    for gaps_at in (lambda j: (tol * 2, {11: 0.0, 9: tol * 2}),  # a clear margin
                    lambda j: (tol / 4, {11: 0.0, 9: tol * 3}),  # 9 is far below
                    lambda j: (tol / 4, {11: tol * 3, 9: 0.0})):
        with pytest.raises(RuntimeError, match="first differs at step 4"):
            chip_smoke.check_handoff(got, whole, 3, got[3:], True, gaps_at)
    for k, tail, done in ((3, [8, 11, 13], True), (3, got[3:], False), (0, got, True),
                          (6, [], True)):
        with pytest.raises(RuntimeError, match="tail after step"):
            chip_smoke.check_handoff(got, whole, k, tail, done,
                                     lambda j: (0.0, {11: 0.0, 9: 0.0}))


def _tiny_train(monkeypatch):
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "TINY_SEQ", 16)
    return llama.LlamaConfig.tiny(vocab_size=256)


def test_train_phase_rehearses_on_cpu(monkeypatch):
    """Phase 12 at the tiny preset (bf16, as on the card): the child trains
    on a repeated batch and the loss falls, the in-process gradient check
    finds every grad, the tiny entry point resumes to 7 steps and its
    pushes upload the 4 changed files, then none."""
    stats = chip_smoke.phase_train(device="cpu", cfg=_tiny_train(monkeypatch))
    assert stats["train_fwd_launches"] == stats["train_bwd_launches"] == 0  # the plain versions
    losses = stats["train_losses"]
    assert len(losses) == chip_smoke.TRAIN_STEPS and losses[-1] < losses[0]
    assert stats["train_grad_gap"] == 0.0  # on the CPU both paths are the reference
    assert stats["train_loss_gap"] == 0.0
    assert stats["train_tiny_steps"] == 7 and stats["train_push_changed"] == 4
    assert stats["train_push_blobs"] == [4, 4, 0]  # 3 shards + checkpoint.json
    assert stats["train_bytes_written"] > 0 and stats["train_phase_s"] > 0


def test_train_phase_fails_when_a_grad_is_none(monkeypatch):
    """A kernel output with no grad_fn leaves the q/k/v projections out of
    the graph: the gradient check names them."""
    from modelx_tpu_torch.models import llama as port_llama

    real = port_llama.forward

    def detached(params, tokens, cfg, attention_impl="auto", **kw):
        if attention_impl == "auto":
            params = {n: (t.detach() if n.endswith(("q_proj.weight", "k_proj.weight",
                                                    "v_proj.weight")) else t)
                      for n, t in params.items()}
        return real(params, tokens, cfg, attention_impl=attention_impl, **kw)

    monkeypatch.setattr(port_llama, "forward", detached)
    monkeypatch.setattr(chip_smoke, "TINY_STEPS", (1, 1, 1))
    with pytest.raises(RuntimeError, match=r"no gradient reached .*q_proj"):
        chip_smoke.phase_train(device="cpu", cfg=_tiny_train(monkeypatch))


def test_train_launch_check_fails_when_the_backward_is_not_launched():
    chip_smoke.check_train_launches("ok", 16, 16, 16)
    with pytest.raises(RuntimeError, match="flash_attention_backward launched 0 times, want 16"):
        chip_smoke.check_train_launches("the full-width run", 16, 0, 16)
    with pytest.raises(RuntimeError, match="flash_attention launched 0 times, want 16"):
        chip_smoke.check_train_launches("the full-width run", 0, 16, 16)


def test_grad_check_holds_the_tolerance():
    plain = {"a": torch.ones(4), "b": torch.ones(3)}
    assert chip_smoke.check_grads({"a": torch.ones(4), "b": torch.ones(3)}, plain, 0.05)[0] == 0
    with pytest.raises(RuntimeError, match="relative L2"):
        chip_smoke.check_grads({"a": torch.ones(4), "b": torch.ones(3) * 1.2}, plain, 0.05)
    with pytest.raises(RuntimeError, match="no gradient reached"):
        chip_smoke.check_grads({"a": torch.ones(4), "b": None}, plain, 0.05)


def test_train_loss_check_holds_the_tolerance():
    assert chip_smoke.check_train_loss(12.0, 12.0, 1e-3) == 0.0
    assert chip_smoke.check_train_loss(12.006, 12.0, 1e-3) == pytest.approx(5e-4)
    for flash in (12.1, float("nan")):
        with pytest.raises(RuntimeError, match="loss through the kernels"):
            chip_smoke.check_train_loss(flash, 12.0, 1e-3)


def test_backward_bound_counts_five_products():
    # the training shape: 10*D per visible pair, ~86 GFLOP at 989 TFLOP/s
    ms, by = chip_smoke.backward_bound(1, 32, 8, 2048, 128, True, 0, "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(10 * 128 * 2048 * 2049 / 2 * 32 / 989e9)
    assert ms == pytest.approx(2.5 * chip_smoke.attention_bound(
        1, 32, 8, 2048, 128, True, 0, "bfloat16")[0])


def test_mesh_phase_rehearses_on_cpu(monkeypatch):
    """``--phases kernels,mesh`` off the card at a tiny size: (a) a world of
    1 over gloo through ``serve_main --mesh`` (dp=1,tp=1; Ulysses and the
    ring at sp=1) against the meshless server, and (b) two ranks over gloo
    (tp=2, Ulysses and the ring at sp=2) against the meshless logits; no
    collective is refused on CPU tensors and no kernel is launched."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=1024), rope_theta=500000.0)
    monkeypatch.setattr(chip_smoke, "MESH_FORWARD", (1, 48))
    monkeypatch.setattr(chip_smoke, "MESH_PROMPT", 12)
    monkeypatch.setattr(chip_smoke, "MESH_NEW_TOKENS", 6)
    monkeypatch.setattr(chip_smoke, "MESH_B_SEQ", 32)
    stats = chip_smoke.phase_mesh(device="cpu", cfg=cfg)
    assert stats["flash_launches_mesh"] == 0 and stats["mesh_b_refused"] == []
    for spec, impl in chip_smoke.MESH_A_RUNS:
        assert stats[f"mesh_a_{spec}_{impl}"]["launches"] == 0
    for spec, impl, _ in chip_smoke.MESH_B_RUNS:
        run = stats[f"mesh_b_{spec} {impl}"]
        assert run["max_abs_err"] <= chip_smoke.MESH_B_TOL[f"{spec} {impl}"]
    # tp=2: rank 0 read its slices, about half the checkpoint
    tp = stats["mesh_b_tp=2 auto"]
    assert tp["rank_load_bytes"] < 0.6 * stats["mesh_bytes_written"]


class _Exited:
    def __init__(self, rc):
        self.rc = rc

    def wait(self, timeout=None):
        return self.rc


def _probes(tmp_path, outcomes: dict) -> dict:
    probes = {}
    for (name, rank), (rc, text) in outcomes.items():
        path = tmp_path / f"{name}-{rank}.log"
        path.write_text(text)
        probes[(name, rank)] = (_Exited(rc), str(path))
    return probes


def test_mesh_probes_accept_only_gloos_point_to_point_abort(tmp_path):
    ok = (0, "PROBE_OK\n")
    closed = (1, "RuntimeError: [gloo/transport/tcp/pair.cc] Connection closed by peer\n")
    aborted = (-6, "[enforce fail at gloo/transport/tcp/pair.cc] writev: Bad address\n")
    refused = chip_smoke._refused(_probes(tmp_path, {
        ("all_reduce", 0): ok, ("all_reduce", 1): ok,
        ("batch_isend_irecv", 0): closed, ("batch_isend_irecv", 1): aborted}))
    assert list(refused) == ["batch_isend_irecv"] and "Bad address" in refused["batch_isend_irecv"]
    # the same failure on another collective, or the ring's probe failing
    # some other way, fails the phase
    for outcomes in ({("all_to_all_single", 0): closed, ("all_to_all_single", 1): aborted},
                     {("batch_isend_irecv", 0): closed, ("batch_isend_irecv", 1): closed}):
        with pytest.raises(RuntimeError, match="probe failed"):
            chip_smoke._refused(_probes(tmp_path, outcomes))
