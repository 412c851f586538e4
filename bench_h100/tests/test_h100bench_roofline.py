"""The busy union, the idle gaps and the roofline arithmetic on hand-built
traces and batches."""
import numpy as np
import pytest

from bench_h100 import roofline
from bench_h100.trace import (busy_us, idle_gaps, kernel_us, label_gaps,
                              top_ops)

ACTS = [(0.0, 10.0, "kernel", "void decode_kernel<128, 5>(...)"),
        (5.0, 12.0, "gpu_memcpy", "Memcpy HtoD"),
        (20.0, 30.0, "kernel", "void latent_decode_kernel<512>(...)"),
        (25.0, 26.0, "kernel", "chunk_kernel"),
        (40.0, 45.0, "kernel", "nvjet_gemm")]


def test_busy_union_counts_overlap_once():
    assert busy_us(ACTS) == 12.0 + 10.0 + 5.0


def test_kernel_names_match_whole_words():
    assert kernel_us(ACTS, ("decode_kernel",)) == 10.0
    assert kernel_us(ACTS, ("latent_decode_kernel",)) == 10.0
    assert kernel_us(ACTS, ("chunk_kernel", "latent_chunk_kernel")) == 1.0


def test_idle_gaps_and_their_labels():
    gaps = idle_gaps(ACTS, 0.0, 50.0)
    assert gaps == [(12.0, 20.0), (30.0, 40.0), (45.0, 50.0)]
    spans = [("dispatch", 11.0, 19.0), ("emit_wait", 31.0, 33.0)]
    assert label_gaps(gaps, spans) == [["emit_wait", 10e-6],
                                       ["dispatch", 8e-6],
                                       ["host_idle", 5e-6]]
    assert top_ops(ACTS)[0][1] == pytest.approx(10e-6)


QWEN = roofline.Shapes.of({
    "num_hidden_layers": 48, "hidden_size": 5120, "num_attention_heads": 40,
    "num_key_value_heads": 8, "intermediate_size": 13824,
    "vocab_size": 152064})
DSV2 = roofline.Shapes.of({
    "num_hidden_layers": 27, "hidden_size": 2048, "num_attention_heads": 16,
    "num_key_value_heads": 16, "intermediate_size": 10944,
    "vocab_size": 102400, "kv_lora_rank": 512, "qk_rope_head_dim": 64,
    "qk_nope_head_dim": 128, "v_head_dim": 128, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "moe_intermediate_size": 1408,
    "n_shared_experts": 2, "first_k_dense_replace": 1})


def test_weights_per_token_match_the_published_sizes():
    # qwen2.5-14b: 14.77 B parameters less the embedding and the LM head
    assert QWEN.weight_macs_per_token() == 48 * (
        5120 * 5120 + 2 * 5120 * 1024 + 5120 * 5120 + 3 * 5120 * 13824)
    assert 13.0e9 < QWEN.weight_macs_per_token() < 13.3e9
    # deepseek-v2-lite: ~2.4 B active, less embedding and head (0.42 B)
    assert 2.0e9 < DSV2.weight_macs_per_token() < 2.4e9


def test_shared_pages_are_read_once():
    tables = np.array([[0, 1, 2, -1], [0, 1, 3, -1], [4, -1, -1, -1]])
    lens = np.array([150, 140, 10])
    # pages 0 and 1 shared (64 + 64), page 2: 22, page 3: 12, page 4: 10
    assert roofline.distinct_page_tokens(tables, lens, 64) == 172


def test_decode_launch_bytes_and_flops():
    tables = np.array([[0, 1], [2, -1]])
    lens = np.array([100, 30])
    nbytes, flops = roofline.attention_launch(QWEN, [99, 29], tables, lens,
                                              64)
    tok = 2 * 8 * (128 + 4)
    assert nbytes == 130 * tok + 2 * (2 * 40 * 128 * 2)
    assert flops == 130 * 4 * 40 * 128
    assert roofline.bound(nbytes, flops) == pytest.approx(
        nbytes / roofline.HBM_BYTES_PER_S)


def test_latent_launch_counts_the_absorbed_kernel():
    nbytes, flops = roofline.attention_launch(DSV2, [63], np.array([[5]]),
                                              np.array([64]), 64)
    assert nbytes == 64 * (576 + 8) + 16 * (1024 + 64) * 4
    assert flops == 64 * 2 * 16 * (1024 + 64)


def test_step_flops_count_real_rows_and_sampled_heads():
    f = roofline.step_model_flops(QWEN, [0, 1, 2], sampled=1)
    assert f == (2 * 3 * QWEN.weight_macs_per_token()
                 + 48 * (1 + 2 + 3) * 4 * 40 * 128 + 2 * 5120 * 152064)
