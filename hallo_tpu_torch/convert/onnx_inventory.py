"""Expected ONNX op inventories of the production model files.

The reference pipeline runs three .onnx models through onnxruntime
(image_processor.py:100-138 via insightface, audio_processor.py:50-64 via
audio-separator); hallo_tpu runs them through `convert.onnx_jax.OnnxExecutor`
instead, and the port through `convert.onnx_torch.OnnxExecutor` (this file
is the port's copy of hallo_tpu/convert/onnx_inventory.py). These are the op sets those model families are known to use
(public Netron inspections of the insightface `antelopev2`/`buffalo_l`
bundles and the MDX-Net vocal models) — recorded as a *coverage contract*:
`tests/test_onnx_jax.py` and `tests/test_torch_onnx.py` assert the executors support every op listed
here, so loading the real files cannot fail on op dispatch. When the real
files are present, the gated test runs `OnnxExecutor.check_support` on the
actual graphs (the authoritative check — inventories here are the
documented expectation, superset-safe).
"""

from __future__ import annotations

# SCRFD-10G with batchnorm + 5 keypoints (face detector).
# ResNet-style backbone + PAFPN neck + per-stride heads; score sigmoid is
# in-graph, bbox/kps decode + NMS are outside (data/insight_jax.py).
SCRFD_10G_BNKPS = frozenset({
    "Conv", "BatchNormalization", "Relu", "PRelu", "Add", "Mul", "Div",
    "Sub", "MaxPool", "AveragePool", "GlobalAveragePool", "Sigmoid",
    "Concat", "Reshape", "Transpose", "Shape", "Gather", "Unsqueeze",
    "Squeeze", "Slice", "Resize", "Upsample", "Exp", "Identity",
    "Constant", "Softmax", "Flatten",
})

# ArcFace iResNet-100 (512-d identity embedding).
GLINTR100 = frozenset({
    "Conv", "BatchNormalization", "PRelu", "Add", "Flatten", "Gemm",
    "MatMul", "Reshape", "Identity", "Constant", "Dropout",
})

# MDX-Net vocal separator (Kim_Vocal_2): Conv/ConvTranspose U-Net with
# TDF (frequency-dense) blocks; STFT/iSTFT live OUTSIDE the graph
# (data/mdx_separator.py re-derives them in jnp).
KIM_VOCAL_2 = frozenset({
    "Conv", "ConvTranspose", "BatchNormalization", "InstanceNormalization",
    "Relu", "LeakyRelu", "Add", "Concat", "Reshape", "Transpose", "MatMul",
    "Gemm", "Sigmoid", "Tanh", "Mul", "Slice", "Identity", "Constant",
    "Shape", "Unsqueeze", "Squeeze", "Gather", "Cast",
})

# MediaPipe FaceMesh(-with-attention) ONNX conversion — the PINNED
# production landmark model for hallo_tpu/data/landmark_jax.py (the
# reference uses the same network via mediapipe's .task runtime,
# util.py:351-404). Recommended artifact: PINTO model zoo
# `030_FaceMesh/face_landmark_Nx3x192x192.onnx` (1x3x192x192 float input,
# 1404 = 468*3 landmark output in crop pixels) — see README "Dense
# landmarks". Op set per public Netron inspection of that conversion
# family (MobileNet-style backbone with PReLU, landmark + score heads);
# superset-safe.
FACE_MESH = frozenset({
    "Conv", "PRelu", "Relu", "Sigmoid", "Add", "Mul", "Sub", "Div", "Pad",
    "MaxPool", "AveragePool", "GlobalAveragePool", "Reshape", "Transpose",
    "Concat", "Slice", "Squeeze", "Unsqueeze", "Shape", "Gather",
    "Identity", "Constant", "Gemm", "MatMul", "Flatten", "Split",
})

KNOWN_MODEL_OPS = {
    "scrfd_10g_bnkps": SCRFD_10G_BNKPS,
    "glintr100": GLINTR100,
    "Kim_Vocal_2": KIM_VOCAL_2,
    "face_landmark": FACE_MESH,
}
