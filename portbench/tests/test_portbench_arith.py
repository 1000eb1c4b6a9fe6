"""The yardstick's FLOP and byte counts against counts made by hand."""
import json

from conftest import HERE

import arith


def _model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


def test_glm4_9b_row_flops():
    # per layer: q and o 4096 x 4096, k and v 4096 x 256, the SwiGLU 3 x 4096 x 13696
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696
    assert per_layer == 203_948_032
    assert arith.active_matmul_params(_model("glm4-9b")) == 40 * per_layer == 8_157_921_280
    # 8 tokens through the layers, and the last position's 4096 x 151552 head
    assert arith.row_flops(_model("glm4-9b")) == 2 * 8_157_921_280 * 8 + 2 * 4096 * 151_552
    assert arith.row_flops(_model("glm4-9b")) == 131_768_254_464


def test_arctic_row_flops():
    # q and o 7168 x 7168, k and v 7168 x 1024; two experts, each 3 x 7168 x
    # 4864; the dense residual 3 x 7168 x 7168 (its width is the model's);
    # the router 7168 x 128
    per_layer = (2 * 7168 * 7168 + 2 * 7168 * 1024) + 2 * 3 * 7168 * 4864 \
        + 3 * 7168 * 7168 + 7168 * 128
    assert per_layer == 481_689_600
    assert arith.active_matmul_params(_model("arctic-480b")) == 2 * per_layer
    assert arith.row_flops(_model("arctic-480b")) == 16 * 963_379_200 + 2 * 7168 * 32_000
    assert arith.row_flops(_model("arctic-480b")) == 15_872_819_200


def test_serve_call_bytes():
    # a bucket of 256, 100 sets touched (8 ways: 128 B a row), 30 deferred
    # writes of 8 values, 50 value rows gathered
    per_request_in = 4 * 5 + 2
    per_request_out = 3 + 12 + 32
    want = 256 * (per_request_in + per_request_out) + 2 * 100 * 128 + 30 * (4 + 64) + 50 * 32
    assert arith.serve_call_bytes(256, 100, 8, 8, 30, 50) == want


def test_pow2():
    assert [arith.pow2(n) for n in (1, 2, 3, 1000, 1024, 1025)] == [1, 2, 4, 1024, 1024, 2048]


def test_serve_fused_roofline_reader():
    from types import SimpleNamespace as NS

    import numpy as np

    import readers

    # two calls of 3 and 2 requests after a warm call of 2; request 1 is
    # static, request 3 hits row 17, requests 0 and 2 (sets 4, 5) inserted
    rp = NS(static=np.array([0, 0, 0, 1, 0, 0, 0], bool), sets=np.array([9, 9, 4, 0, 5, 4, 2]),
            hit_row=np.array([-1, -1, -1, -1, -1, 17, -1]),
            inserted=np.array([1, 1, 1, 0, 1, 0, 1], bool))
    calls = [NS(lo=0, hi=2, n=2), NS(lo=2, hi=5, n=3), NS(lo=5, hi=7, n=2)]
    trace = NS(ops=[("(anonymous namespace)::fill_kernel(int*, int, int, int const*, int const*, "
                     "int)", 0.0, 1e-6),
                    ("void (anonymous namespace)::probe_and_commit_kernel<8, true>(Args)", 0.0, 3e-6),
                    ("nvjet_tst_320x128", 0.0, 1.0)])
    run = NS(trace=trace, window=calls[1:], window_prev=calls[0], replay=rp, min_bucket=4,
             cfg={"cache": {"ways": 8, "value_dim": 8}})
    want = (arith.serve_call_bytes(4, 2, 8, 8, 2, 0)  # sets 4, 5; the warm call's 2 inserts
            + arith.serve_call_bytes(4, 2, 8, 8, 2, 1))  # sets 4, 2; row 17
    assert abs(readers.serve_fused_roofline(run) - 100 * want / 3.35e12 / 4e-6) < 1e-9
    run.trace = NS(ops=[("nvjet_tst_320x128", 0.0, 1.0)])
    assert readers.serve_fused_roofline(run) is None
