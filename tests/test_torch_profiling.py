"""The port's profiler trace (`hallo_tpu_torch/utils/profiling.py`) on the
CPU: `summarize_device_time` on a small hand-written Chrome trace pins the
categories (each of the port's kernels by its symbol, cuDNN, cuBLAS,
reductions, PyTorch's elementwise and copy kernels, memcpy / memset, NCCL,
the rest), the totals, launches and top kernels; `trace` writes a Chrome
trace on the CPU that reads back with no device time; `profile_step` runs
the tiny widths on the CPU and refuses the card's default without one.
"""

import json

import pytest
import torch

from hallo_tpu_torch import profile_step
from hallo_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# (name, chrome-trace category, microseconds, expected category)
DEVICE_EVENTS = [
    ("void flash_fwd_sm90_kernel<80, 128, true>(FwdParams)", "kernel", 100.0,
     "K1 flash_fwd_sm90"),
    ("void flash_fwd_sm90_kernel<40, 128, false>(FwdParams)", "kernel", 20.0,
     "K1 flash_fwd_sm90"),
    ("void temporal_sm90_kernel<64>(TemporalParams)", "kernel", 30.0, "K2/K7 temporal_sm90"),
    ("void flash_fwd_t_sm90_kernel<64, 2>(TParams)", "kernel", 3.0, "K3 flash_fwd_t_sm90"),
    ("flash_fwd_d512_kernel", "kernel", 40.0, "K4 flash_fwd_d512"),
    ("void flash_bwd_dkv_sm90_kernel<80>(BwdParams)", "kernel", 50.0, "K5 flash_bwd_sm90"),
    ("void flash_bwd_dq_sm90_kernel<80>(BwdParams)", "kernel", 45.0, "K5 flash_bwd_sm90"),
    ("void flash_int8_sm90_kernel<64, 2>(Int8Params)", "kernel", 2.0, "K6 flash_int8_sm90"),
    ("int8_prelude_kernel", "kernel", 1.0, "K6 flash_int8_sm90"),
    ("winograd_kernel", "kernel", 7.0, "K8 winograd"),
    ("layout_copy_kernel", "kernel", 6.0, "K9 layout_copy"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)",
     "kernel", 9.0, "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "kernel", 60.0, "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(...)", "kernel", 4.0,
     "convolution"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "kernel", 70.0, "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1",
     "kernel", 25.0, "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>>>>(...)",
     "kernel", 12.0, "norms"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<"
     "c10::BFloat16>, at::detail::Array<char*, 3>>(int, ...)", "kernel", 33.0, "elementwise"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<"
     "float, 4, at::native::templates::cuda::normal_and_transform<...>>(...)", "kernel", 5.0,
     "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>>(int, ...)",
     "kernel", 11.0, "copies"),
    ("void at::native::unrolled_elementwise_kernel<at::native::convert_dtype<float>>(...)",
     "kernel", 2.5, "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 8.0, "copies"),
    ("Memset (Device)", "gpu_memset", 1.5, "copies"),
    ("void at::native::(anonymous namespace)::softmax_warp_forward<float, float, float, 5>"
     "(float*, float const*, int, int, int)", "kernel", 3.5, "other"),
]


def chrome_trace(path) -> None:
    events = [{"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 1000.0 + i,
               "dur": us} for i, (name, cat, us, _) in enumerate(DEVICE_EVENTS)]
    # host events the summary must leave out of device time; three launches
    events += [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 500.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
         "ts": 1.0, "dur": 4.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "pid": 1, "tid": 1,
         "ts": 2.0, "dur": 4.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "pid": 1, "tid": 1,
         "ts": 3.0, "dur": 4.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 1, "tid": 1,
         "ts": 4.0, "dur": 4.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 1000.0},
        # device spans of annotated ranges: kept apart, outside the total
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nccl:all_gather", "pid": 0,
         "tid": 7, "ts": 1000.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "nccl:all_gather", "pid": 0,
         "tid": 7, "ts": 1010.0, "dur": 2.0},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    ]
    with open(path, "w") as fh:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fh)


@pytest.mark.parametrize("name,cat,us,want", DEVICE_EVENTS,
                         ids=[e[3] + "-" + str(i) for i, e in enumerate(DEVICE_EVENTS)])
def test_device_category(name, cat, us, want):
    assert profiling.device_category(name) == want


def test_summarize_device_time_pins_categories(tmp_path):
    chrome_trace(tmp_path / profiling.TRACE_FILE)
    out = profiling.summarize_device_time(str(tmp_path), top_n=3)
    want_ms, want_n = {}, {}
    for _, _, us, cat in DEVICE_EVENTS:
        want_ms[cat] = want_ms.get(cat, 0.0) + us / 1e3
        want_n[cat] = want_n.get(cat, 0) + 1
    assert out["total_ms"] == pytest.approx(sum(e[2] for e in DEVICE_EVENTS) / 1e3)
    assert out["by_category_ms"] == pytest.approx(want_ms)
    assert list(out["by_category_ms"].values()) == sorted(out["by_category_ms"].values(),
                                                          reverse=True)
    assert out["launches_by_category"] == want_n
    assert out["launch_calls"] == 3
    assert out["annotations_ms"] == pytest.approx({"nccl:all_gather": 0.005})
    assert out["annotation_counts"] == {"nccl:all_gather": 2}
    # the top kernels by time, without `void ` and their argument lists; K1's
    # two instantiations stay apart
    assert out["top_ops_ms"] == pytest.approx({
        "flash_fwd_sm90_kernel<80, 128, true>": 0.1,
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": 0.07,
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64": 0.06,
    })
    # the file itself may be given
    assert profiling.summarize_device_time(str(tmp_path / profiling.TRACE_FILE)) == \
        profiling.summarize_device_time(str(tmp_path))


def test_summarize_device_time_without_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_device_time(str(tmp_path))


def test_trace_writes_chrome_trace_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    out = profiling.summarize_device_time(str(tmp_path / "t"))
    assert out["total_ms"] == 0.0 and out["by_category_ms"] == {} and out["launch_calls"] == 0
    assert out["annotations_ms"] == {}


def test_profile_step_tiny_on_cpu(tmp_path):
    from hallo_tpu_torch.utils.factory import build_models

    models = build_models("tiny", device="cpu", seed=0)
    out = profile_step.profile(models, 64, 4, 2, str(tmp_path))
    assert json.loads(json.dumps(out)) == out
    assert out["device"] == "cpu" and out["loops"] == 2 and out["frames"] == 4
    # no device numbers from a CPU run
    assert out["ms_per_step_device"] is None and out["busy_share"] is None
    assert out["total_ms"] == 0.0 and out["wall_ms_per_step"] > 0
    assert (tmp_path / profiling.TRACE_FILE).exists()


def test_profile_step_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profile_step.main(["--loops", "1"])
