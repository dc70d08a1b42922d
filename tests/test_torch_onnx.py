"""The port's ONNX executor and its users against hallo_tpu's, on the CPU
in fp32.

The graphs are the synthetic ones of tests/test_onnx_jax.py,
test_landmark_jax.py and test_mdx_separator.py (written with the port's
`onnx_io.save_onnx`, a copy of the JAX package's), plus an op zoo that
reaches every op of `supported_ops` the others do not. Each runs through
`hallo_tpu.convert.onnx_jax.OnnxExecutor` and through the port's
`convert.onnx_torch.OnnxExecutor` (device "cpu"), with the same inputs
from numpy seeds. Both sides are fp32 in another order of sums (XLA against
ATen): the tolerance is a relative L2 error of 1e-5, and detections must be
equal (the same boxes kept, in the same order).
"""

import os

import numpy as np
import pytest
import torch

from hallo_tpu.convert import onnx_inventory as jax_inventory
from hallo_tpu.convert.onnx_io import save_onnx as jax_save_onnx
from hallo_tpu.convert.onnx_jax import OnnxExecutor as JaxExecutor
from hallo_tpu_torch.convert import onnx_inventory
from hallo_tpu_torch.convert.onnx_io import OnnxNode, load_onnx, save_onnx
from hallo_tpu_torch.convert.onnx_torch import OnnxExecutor, UnsupportedOnnxOps

from tests.test_landmark_jax import synthetic_landmarks
from tests.test_onnx_jax import _build_tiny_scrfd

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the port's CPU runs here: the suite runs
    these files beside five other workers, where torch's default of one
    thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _node(op, inputs, outputs, **attrs):
    return OnnxNode(op, list(inputs), list(outputs), attrs)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cnn(rng):
    """test_onnx_jax.py::test_cnn_vs_torch_oracle's graph."""
    nodes = [
        _node("Conv", ["x", "w1", "b1"], ["c1"], strides=[2, 2], pads=[1, 1, 1, 1]),
        _node("BatchNormalization", ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["bn"],
              epsilon=1e-5),
        _node("PRelu", ["bn", "slope"], ["pr"]),
        _node("MaxPool", ["pr"], ["mp"], kernel_shape=[3, 3], strides=[2, 2],
              pads=[0, 0, 0, 0], ceil_mode=1),
        _node("Resize", ["mp", "", "scales"], ["up"], mode="nearest",
              coordinate_transformation_mode="asymmetric"),
        _node("Concat", ["pr", "up"], ["cat"], axis=1),
        _node("Conv", ["cat", "w2"], ["c2"]),
        _node("GlobalAveragePool", ["c2"], ["gap"]),
        _node("Flatten", ["gap"], ["fl"], axis=1),
        _node("Gemm", ["fl", "gw", "gb"], ["out"], transB=1),
    ]
    inits = dict(
        w1=rng.normal(size=(8, 3, 3, 3), scale=0.2), b1=rng.normal(size=(8,)),
        bn_s=rng.uniform(0.5, 1.5, 8), bn_b=rng.normal(size=(8,)),
        bn_m=rng.normal(size=(8,), scale=0.1), bn_v=rng.uniform(0.5, 2.0, 8),
        slope=rng.uniform(0.1, 0.3, (8, 1, 1)), w2=rng.normal(size=(4, 16, 1, 1), scale=0.2),
        gw=rng.normal(size=(6, 4), scale=0.3), gb=rng.normal(size=(6,)),
        scales=np.array([1.0, 1.0, 2.0, 2.0]))
    return nodes, inits, {"x": [1, 3, 16, 16]}, {"out": [1, 6]}


def _fold(rng):
    """test_shape_subgraph_folding's exporter pattern."""
    nodes = [
        _node("Shape", ["x"], ["sh"]),
        _node("Gather", ["sh", "zero"], ["b"], axis=0),
        _node("Unsqueeze", ["b"], ["b1"], axes=[0]),
        _node("Concat", ["b1", "minus1"], ["target"], axis=0),
        _node("Reshape", ["x", "target"], ["flat"]),
        _node("Softmax", ["flat"], ["out"], axis=1),
    ]
    inits = {"zero": np.array(0, np.int64), "minus1": np.array([-1], np.int64)}
    return nodes, inits, {"x": [2, 3, 4]}, {"out": [2, 12]}


def _grouped(rng):
    nodes = [_node("Conv", ["x", "w_dw"], ["d"], pads=[1, 1, 1, 1], group=6),
             _node("Conv", ["d", "w_g"], ["y"], group=2)]
    inits = dict(w_dw=rng.normal(size=(6, 1, 3, 3), scale=0.3),
                 w_g=rng.normal(size=(8, 3, 1, 1), scale=0.3))
    return nodes, inits, {"x": [1, 6, 10, 10]}, {"y": [1, 8, 10, 10]}


def _auto_pad(rng):
    nodes = [_node("Conv", ["x", "w"], ["y"], strides=[2, 2], auto_pad="SAME_UPPER")]
    return nodes, dict(w=rng.normal(size=(4, 3, 3, 3), scale=0.3)), {"x": [1, 3, 9, 9]}, \
        {"y": [1, 4, 5, 5]}


def _pad_attr(rng):
    nodes = [_node("Pad", ["x"], ["y"], mode="constant", pads=[0, 0, 1, 2, 0, 0, 3, 4],
                   value=1.5)]
    return nodes, {}, {"x": [1, 2, 3, 4]}, {"y": [1, 2, 7, 10]}


def _pad_reflect(rng):
    nodes = [_node("Pad", ["x", "pads"], ["y"], mode="reflect")]
    return nodes, {"pads": np.array([0, 0, 0, 1, 0, 0, 0, 2], np.int64)}, \
        {"x": [1, 2, 3, 4]}, {"y": [1, 2, 3, 7]}


def _convtranspose(rng):
    """test_mdx_separator.py's conv/instance-norm/conv-transpose graph."""
    nodes = [
        _node("Conv", ["x", "w_d"], ["d"], strides=[2, 2], pads=[1, 1, 1, 1]),
        _node("InstanceNormalization", ["d", "in_s", "in_b"], ["n"], epsilon=1e-5),
        _node("Relu", ["n"], ["r"]),
        _node("ConvTranspose", ["r", "w_u", "b_u"], ["y"], strides=[2, 2], pads=[1, 1, 1, 1]),
    ]
    inits = dict(w_d=rng.normal(size=(6, 3, 3, 3), scale=0.3),
                 w_u=rng.normal(size=(6, 3, 4, 4), scale=0.3), b_u=rng.normal(size=(3,)),
                 in_s=rng.uniform(0.5, 1.5, 6), in_b=rng.normal(size=(6,)))
    return nodes, inits, {"x": [1, 3, 16, 16]}, {"y": [1, 3, 16, 16]}


def _mdx_unet(rng):
    """test_mdx_tiny_unet_runs's stand-in for Kim_Vocal_2 (output padding)."""
    nodes = [
        _node("Conv", ["x", "w1"], ["d"], strides=[2, 2], pads=[1, 1, 1, 1]),
        _node("InstanceNormalization", ["d", "s1", "b1"], ["n1"]),
        _node("Relu", ["n1"], ["r1"]),
        _node("ConvTranspose", ["r1", "w2"], ["u"], strides=[2, 2], pads=[1, 1, 1, 1],
              output_padding=[1, 1]),
        _node("Conv", ["u", "w3"], ["y"]),
    ]
    inits = dict(w1=rng.normal(size=(8, 4, 3, 3), scale=0.2), s1=np.ones(8), b1=np.zeros(8),
                 w2=rng.normal(size=(8, 8, 3, 3), scale=0.2),
                 w3=rng.normal(size=(4, 8, 1, 1), scale=0.2))
    return nodes, inits, {"x": [1, 4, 64, 32]}, {"y": [1, 4, 64, 32]}


def _mesh(rng):
    """test_landmark_jax.py's face-mesh-contract graph."""
    nodes = [_node("ReduceMean", ["x"], ["mu"], axes=[1, 2, 3], keepdims=0),
             _node("Mul", ["mu", "zero"], ["z"]),
             _node("Add", ["z", "lm"], ["landmarks"])]
    inits = {"zero": np.zeros((1,)), "lm": synthetic_landmarks().reshape(1, -1)}
    return nodes, inits, {"x": [1, 192, 192, 3]}, {"landmarks": [1, 1404]}


def _zoo(rng):
    """Every op of `supported_ops` that the graphs above do not reach, on a
    (1, 4, 8, 6) input, with the data-dependent and the folded forms."""
    n = _node
    nodes = [
        n("Sigmoid", ["x"], ["sg"]), n("Tanh", ["x"], ["th"]), n("Erf", ["x"], ["ef"]),
        n("LeakyRelu", ["x"], ["lr"], alpha=0.2), n("Neg", ["x"], ["ng"]),
        n("Exp", ["th"], ["ex"]), n("Log", ["ex"], ["lg"]), n("Sqrt", ["ex"], ["sq"]),
        n("Pow", ["sq", "two"], ["pw"]), n("Floor", ["x"], ["fl"]), n("Ceil", ["x"], ["ce"]),
        n("Min", ["sg", "th", "lr"], ["mn"]), n("Max", ["sg", "th", "lr"], ["mx"]),
        n("Clip", ["x"], ["cl"], min=-0.5, max=0.7),
        n("Clip", ["x", "lo", "hi"], ["cl2"]),
        n("Sub", ["mx", "mn"], ["sb"]), n("Div", ["sb", "ex"], ["dv"]),
        n("Dropout", ["dv"], ["dp"]), n("Identity", ["dp"], ["id"]),
        n("Equal", ["fl", "ce"], ["eq"]), n("Where", ["eq", "x", "ng"], ["wh"]),
        n("Cast", ["eq"], ["eqf"], to=1), n("Add", ["wh", "eqf"], ["a1"]),
        n("ReduceSum", ["a1"], ["rs"], axes=[1], keepdims=1),
        n("ReduceMax", ["a1"], ["rm"], axes=[2, 3], keepdims=1),
        n("ReduceProd", ["cl"], ["rp"], axes=[1], keepdims=0),
        n("Mul", ["rs", "rm"], ["m1"]),
        n("Slice", ["a1", "st", "en", "ax", "sp"], ["sl"]),
        n("Gather", ["a1", "gidx"], ["ga"], axis=3),
        n("Split", ["ga"], ["s0", "s1"], axis=1, split=[1, 3]),
        n("Tile", ["s0", "reps"], ["tl"]),
        n("Expand", ["s0", "eshape"], ["ep"]),
        n("Transpose", ["ep"], ["tp"], perm=[0, 1, 3, 2, 4]),
        n("Squeeze", ["rp"], ["sqz"], axes=[0]),
        n("AveragePool", ["a1"], ["ap0"], kernel_shape=[3, 3], strides=[2, 2],
          pads=[1, 1, 1, 1]),
        n("AveragePool", ["a1"], ["ap1"], kernel_shape=[3, 3], strides=[2, 2],
          pads=[1, 1, 1, 1], count_include_pad=1),
        n("Resize", ["a1", "", "rscales"], ["rz"], mode="linear"),
        n("Upsample", ["a1", "uscales"], ["up"], mode="nearest"),
        n("Resize", ["a1", "", "", "rsizes"], ["rzn"], mode="nearest"),
        n("Softmax", ["cl2"], ["smx"], axis=-1),
        # the folded shape forms: Range, ConstantOfShape, Constant, ReduceProd
        n("Shape", ["x"], ["shx"]),
        n("Constant", [], ["c4"], value=np.array([4], np.int64)),
        n("Slice", ["shx", "c2", "c4"], ["hw0"]),
        n("ReduceProd", ["hw0"], ["hw"], keepdims=1),
        n("Range", ["r0", "r6", "r1"], ["rng"]),
        n("ConstantOfShape", ["shx"], ["zeros"], value=np.array([0.5], np.float32)),
        n("Add", ["x", "zeros"], ["xz"]),
        n("Concat", ["one1", "hw"], ["tgt"], axis=0),
        n("Reshape", ["xz", "tgt"], ["r2"]),
        n("Gemm", ["gx", "gwt", "gb"], ["gm"], transA=1, alpha=0.5, beta=2.0),
        n("MatMul", ["r2", "mw"], ["mm"]),
        n("Cast", ["rng"], ["rngf"], to=1),
        n("Add", ["mm", "rngf"], ["mmr"]),
        n("Flatten", ["tp"], ["ftp"], axis=2),
    ]
    inits = dict(
        two=np.array([2.0]), lo=np.array(-0.3), hi=np.array(0.4),
        st=np.array([0, 7, 5], np.int64), en=np.array([3, 1, -100], np.int64),
        ax=np.array([1, 2, 3], np.int64), sp=np.array([1, -2, -1], np.int64),
        gidx=np.array([[0, -1], [2, 3]], np.int64), reps=np.array([1, 2, 1, 1, 1], np.int64),
        eshape=np.array([2, 1, 1, 1], np.int64), rscales=np.array([1.0, 1.0, 2.0, 1.5]),
        uscales=np.array([1.0, 1.0, 2.0, 2.0]), rsizes=np.array([1, 4, 5, 9], np.int64),
        c2=np.array([2], np.int64), r0=np.array(0, np.int64), r6=np.array(6, np.int64),
        r1=np.array(1, np.int64), one1=np.array([4], np.int64),
        gx=rng.normal(size=(5, 3)), gwt=rng.normal(size=(5, 7)), gb=rng.normal(size=(7,)),
        mw=rng.normal(size=(48, 6)),
    )
    outs = ["m1", "sl", "s1", "tl", "sqz", "ap0", "ap1", "rz", "up", "rzn", "smx", "gm",
            "mmr", "ftp", "pw", "lg", "id"]
    return nodes, inits, {"x": [1, 4, 8, 6]}, {o: [1] for o in outs}


GRAPHS = {
    "cnn": _cnn, "fold": _fold, "grouped": _grouped, "auto_pad": _auto_pad,
    "pad_attr": _pad_attr, "pad_reflect": _pad_reflect, "convtranspose": _convtranspose,
    "mdx_unet": _mdx_unet, "mesh": _mesh, "zoo": _zoo,
}


def write_graph(path, name, seed=0):
    rng = np.random.default_rng(seed)
    nodes, inits, inputs, outputs = GRAPHS[name](rng)
    inits = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
             for k, v in ((k, np.asarray(v)) for k, v in inits.items())}
    save_onnx(path, nodes, inits, inputs, outputs)
    return inputs


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_executor_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.onnx")
    inputs = write_graph(path, name)
    rng = np.random.default_rng(1)
    feed = {k: rng.normal(size=shape).astype(np.float32) for k, shape in inputs.items()}
    jx = JaxExecutor(path)
    want = {k: np.asarray(v) for k, v in jx(jx.params, feed).items()}
    ex = OnnxExecutor(path, device="cpu")
    got = ex(feed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert rel_err(got[k].numpy(), want[k]) <= RTOL, (k, rel_err(got[k].numpy(), want[k]))


def test_planted_weight_fault_is_seen(tmp_path):
    """One conv weight scaled by 1.01 on one side only: the check must see
    it (chip_smoke.py's onnx phase plants the same fault on the card)."""
    path = str(tmp_path / "cnn.onnx")
    feed = {"x": np.random.default_rng(1).normal(size=(1, 3, 16, 16)).astype(np.float32)}
    write_graph(path, "cnn")
    ex = OnnxExecutor(path, device="cpu")
    want = ex(feed)["out"].numpy()
    params = dict(ex.params, w1=ex.params["w1"] * 1.01)
    assert rel_err(ex.run(params, feed)["out"].numpy(), want) > 1e-3


def test_executor_runs_its_graph_without_tf32(tmp_path, monkeypatch):
    """`run` turns cuDNN's and cuBLAS's TF32 off while the graph runs
    (PyTorch lets cuDNN's fp32 convolutions use TF32 by default) and
    restores both switches afterwards, also when a node raises."""
    path = str(tmp_path / "cnn.onnx")
    write_graph(path, "cnn")
    feed = {"x": np.zeros((1, 3, 16, 16), np.float32)}
    seen = []
    real = OnnxExecutor._op_conv

    def spy(self, *args):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(self, *args)

    monkeypatch.setattr(OnnxExecutor, "_op_conv", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ex = OnnxExecutor(path, device="cpu")
    ex(feed)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(OnnxExecutor, "_op_gemm", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        ex(feed)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_onnx_io_copy_writes_the_same_bytes(tmp_path):
    for name in sorted(GRAPHS):
        rng = np.random.default_rng(0)
        nodes, inits, inputs, outputs = GRAPHS[name](rng)
        inits = {k: np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64
                 else np.asarray(v) for k, v in inits.items()}
        ours, theirs = str(tmp_path / "a.onnx"), str(tmp_path / "b.onnx")
        save_onnx(ours, nodes, inits, inputs, outputs)
        jax_save_onnx(theirs, nodes, inits, inputs, outputs)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), name
        assert [nd.op_type for nd in load_onnx(ours).graph.nodes] == [nd.op_type for nd in nodes]


def test_supported_ops_and_inventories_match_jax():
    assert OnnxExecutor.supported_ops() == JaxExecutor.supported_ops()
    assert onnx_inventory.KNOWN_MODEL_OPS == jax_inventory.KNOWN_MODEL_OPS
    for model, ops in onnx_inventory.KNOWN_MODEL_OPS.items():
        assert not sorted(o for o in ops if o.lower() not in OnnxExecutor.supported_ops()), model


def test_unsupported_ops_raise_at_load(tmp_path):
    path = str(tmp_path / "bad.onnx")
    save_onnx(path, [_node("Relu", ["x"], ["h"]), _node("NonMaxSuppression", ["h"], ["h2"]),
                     _node("LSTM", ["h2"], ["y"])], {}, {"x": [1, 4]}, {"y": [1, 4]})
    with pytest.raises(UnsupportedOnnxOps) as exc:
        OnnxExecutor(path, device="cpu")
    assert exc.value.ops == ["LSTM", "NonMaxSuppression"]
    ex = OnnxExecutor(path, strict=False, device="cpu")
    assert ex.check_support(ex.graph) == ["LSTM", "NonMaxSuppression"]


def test_executor_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "cnn.onnx")
    write_graph(path, "cnn")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            OnnxExecutor(path)


# -- the face-analysis apps --------------------------------------------------
def _arcface_graph(path, rng, out_dim=16, stride=8):
    nodes = [_node("Conv", ["x", "w1"], ["c"], strides=[stride, stride], pads=[1, 1, 1, 1]),
             _node("PRelu", ["c", "slope"], ["p"]),
             _node("Flatten", ["p"], ["fl"], axis=1),
             _node("MatMul", ["fl", "gw"], ["emb"])]
    side = (112 + 2 - 3) // stride + 1
    save_onnx(path, nodes, dict(
        w1=rng.normal(size=(6, 3, 3, 3), scale=0.2).astype(np.float32),
        slope=rng.uniform(0.1, 0.3, (6, 1, 1)).astype(np.float32),
        gw=rng.normal(size=(6 * side * side, out_dim), scale=0.05).astype(np.float32)),
        {"x": [1, 3, 112, 112]}, {"emb": [1, out_dim]})


@pytest.fixture
def insight_root(tmp_path):
    root = tmp_path / "face_analysis" / "models"
    root.mkdir(parents=True)
    _build_tiny_scrfd(str(root / "scrfd_tiny_bnkps.onnx"), det=64)
    _arcface_graph(str(root / "glintr_tiny.onnx"), np.random.default_rng(7), out_dim=512)
    return str(tmp_path / "face_analysis")


@pytest.mark.parametrize("thresh", [0.0, 0.5])
def test_scrfd_detections_equal_jax(tmp_path, thresh):
    from hallo_tpu.data.insight_jax import ScrfdJax
    from hallo_tpu_torch.data.insight_torch import ScrfdTorch

    path = str(tmp_path / "scrfd_tiny.onnx")
    _build_tiny_scrfd(path, det=64)
    img = np.random.default_rng(5).integers(0, 255, (96, 80, 3), np.uint8)
    want_boxes, want_kps = ScrfdJax(path, det_size=(64, 64)).detect(img, thresh, 0.4)
    got_boxes, got_kps = ScrfdTorch(path, det_size=(64, 64), device="cpu").detect(img, thresh, 0.4)
    assert got_boxes.shape == want_boxes.shape and len(got_boxes) >= 1
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got_kps, want_kps, rtol=RTOL, atol=1e-4)


def test_arcface_embedding_matches_jax(tmp_path):
    from hallo_tpu.data.insight_jax import ArcFaceJax
    from hallo_tpu_torch.data.insight_torch import ArcFaceTorch

    path = str(tmp_path / "arc_tiny.onnx")
    _arcface_graph(path, np.random.default_rng(6))
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (200, 160, 3), np.uint8)
    kps = np.array([[60, 80], [100, 78], [82, 100], [65, 120], [98, 118]], np.float32)
    want = ArcFaceJax(path).embed(img, kps)
    got = ArcFaceTorch(path, device="cpu").embed(img, kps)
    assert got.shape == want.shape == (16,)
    assert rel_err(got, want) <= RTOL


def test_insight_app_and_face_analyzer_match_jax(insight_root):
    from hallo_tpu.data.face_analysis import FaceAnalyzer as JaxFaceAnalyzer
    from hallo_tpu.data.insight_jax import InsightJaxApp
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer
    from hallo_tpu_torch.data.insight_torch import InsightTorchApp

    """Detections equal; each embedding is held against JAX's ArcFace at the
    port's keypoints (the keypoints agree to 1e-4 pixels, but the aligned
    112x112 crop is uint8, so a 1e-5 shift of a keypoint can round a crop
    pixel the other way: the detector and the embedding are held apart)."""
    img = np.random.default_rng(8).integers(0, 255, (128, 128, 3), np.uint8)
    jax_app = InsightJaxApp(insight_root, det_size=(64, 64))
    want = jax_app.get(img)
    got = InsightTorchApp(insight_root, det_size=(64, 64), device="cpu").get(img)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=RTOL, atol=1e-4)
        np.testing.assert_allclose(g["kps"], w["kps"], rtol=RTOL, atol=1e-4)
        assert rel_err(g["embedding"], jax_app.rec.embed(img, g["kps"])) <= RTOL

    fa = FaceAnalyzer(model_path=insight_root, device="cpu")
    jfa = JaxFaceAnalyzer(model_path=insight_root)
    assert (fa.backend, jfa.backend) == ("onnx-torch", "onnx-jax")
    got_face, want_face = fa.detect(img), jfa.detect(img)
    np.testing.assert_allclose(got_face.bbox, want_face.bbox, rtol=RTOL, atol=1e-3)
    assert rel_err(got_face.embedding, jfa._onnx_jax.rec.embed(img, got_face.kps)) <= RTOL


# -- the face mesh ----------------------------------------------------------
@pytest.fixture
def mesh_path(tmp_path):
    path = str(tmp_path / "face_landmark_468.onnx")
    write_graph(path, "mesh")
    return path


@pytest.mark.parametrize("shape,bbox", [((192, 192, 3), (0, 0, 192, 192)),
                                        ((384, 384, 3), (0, 0, 384, 384)),
                                        ((400, 400, 3), (140, 140, 260, 260)),
                                        ((300, 240, 3), None)])
def test_landmarker_matches_jax(mesh_path, shape, bbox):
    from hallo_tpu.data.landmark_jax import JaxFaceLandmarker
    from hallo_tpu_torch.data.landmark_torch import TorchFaceLandmarker

    img = np.random.default_rng(0).integers(0, 255, shape, np.uint8)
    want = JaxFaceLandmarker(mesh_path)(img, bbox)
    got = TorchFaceLandmarker(mesh_path, device="cpu")(img, bbox)
    assert got.shape == want.shape == (468, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-3)


def test_landmark_masks_and_lookup_match_jax(mesh_path, tmp_path, monkeypatch):
    from hallo_tpu.data.face_analysis import FaceAnalyzer as JaxFaceAnalyzer
    from hallo_tpu.data.landmark_jax import find_landmark_model as jax_find
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer
    from hallo_tpu_torch.data.landmark_torch import find_landmark_model

    root = tmp_path / "fa" / "models"
    root.mkdir(parents=True)
    os.replace(mesh_path, root / "face_landmark_468.onnx")
    for probe in (str(tmp_path / "fa"), str(tmp_path / "absent"), None):
        assert find_landmark_model(probe) == jax_find(probe)
    monkeypatch.setenv("HALLO_LANDMARK_ONNX", str(root / "face_landmark_468.onnx"))
    img = np.full((192, 192, 3), 128, np.uint8)
    got = FaceAnalyzer(model_path="/nonexistent", device="cpu").face_and_lip_masks(img, 1.2)
    want = JaxFaceAnalyzer(model_path="/nonexistent").face_and_lip_masks(img, 1.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].landmarks.shape == (468, 2)


def test_broken_model_file_raises_where_jax_falls_back(tmp_path, monkeypatch):
    """Named divergence: an existing face-mesh file that does not load
    raises in the port; JAX's FaceAnalyzer logs it and keeps its fallback."""
    from hallo_tpu.data.face_analysis import FaceAnalyzer as JaxFaceAnalyzer
    from hallo_tpu_torch.data.face_analysis import FaceAnalyzer

    bad = tmp_path / "face_landmark_468.onnx"
    save_onnx(str(bad), [_node("LSTM", ["x"], ["y"])], {}, {"x": [1, 192, 192, 3]},
              {"y": [1, 1404]})
    monkeypatch.setenv("HALLO_LANDMARK_ONNX", str(bad))
    assert JaxFaceAnalyzer(model_path="/nonexistent")._landmarker is None
    with pytest.raises(UnsupportedOnnxOps):
        FaceAnalyzer(model_path="/nonexistent", device="cpu")


# -- the vocal separator ----------------------------------------------------
def test_stft_istft_match_jax():
    from hallo_tpu.data import mdx_separator as jax_mdx
    from hallo_tpu_torch.data import mdx_separator as mdx

    x = np.random.default_rng(0).normal(size=(2, 40000))
    spec = mdx.stft(torch.from_numpy(x), n_fft=512, hop=128)
    want = jax_mdx.stft(x, n_fft=512, hop=128)
    assert tuple(spec.shape) == want.shape
    np.testing.assert_allclose(spec.numpy(), want, atol=1e-9)
    back = mdx.istft(spec, 512, 128, 40000).numpy()
    np.testing.assert_allclose(back, jax_mdx.istft(want, 512, 128, 40000), atol=1e-9)
    np.testing.assert_allclose(back, x, atol=1e-6)


def _identity_mdx(path, dim_f=64, dim_t=32):
    save_onnx(path, [_node("Identity", ["x"], ["y"])], {}, {"x": [1, 4, dim_f, dim_t]},
              {"y": [1, 4, dim_f, dim_t]})


@pytest.mark.parametrize("graph,sr,seconds", [("identity", 44100, 1.5), ("mdx_unet", 22050, 1.0),
                                              ("identity", 16000, 3.0)])
def test_mdx_separator_matches_jax(tmp_path, graph, sr, seconds):
    from hallo_tpu.data.mdx_separator import MdxSeparatorJax
    from hallo_tpu_torch.data.mdx_separator import MdxSeparator

    path = str(tmp_path / "mdx.onnx")
    if graph == "identity":
        _identity_mdx(path)
    else:
        write_graph(path, graph)
    rng = np.random.default_rng(3)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=t.size)).astype(np.float32)
    want = MdxSeparatorJax(path, hop=40, output_sr=16000).separate(x, sr)
    sep = MdxSeparator(path, hop=40, output_sr=16000, device="cpu")
    got = sep.separate(x, sr)
    assert sep.calls > 1 and got.dtype == np.float32 and got.shape == want.shape
    assert rel_err(got, want) <= RTOL


def test_audio_processor_with_a_separator_matches_jax(tmp_path):
    from hallo_tpu.data.audio_processor import AudioProcessor as JaxAudioProcessor
    from hallo_tpu_torch.convert.from_jax import wav2vec_state_dict_from_jax
    from hallo_tpu_torch.data.audio_processor import AudioProcessor
    from hallo_tpu_torch.utils.factory import WAV2VEC_CONFIGS, build_wav2vec

    from tests.test_torch_audio import WAV_ATOL, WAVS, jax_config, jax_params

    path = str(tmp_path / "Kim_Vocal_2.onnx")
    write_graph(path, "mdx_unet")
    _, params = jax_params("tiny")
    jp = JaxAudioProcessor(wav2vec_params=params, wav2vec_config=jax_config("tiny"),
                           audio_separator_model_path=path)
    assert jp._mdx_jax is not None
    want, want_len = jp.preprocess(f"{WAVS}/1.wav", clip_length=16)
    model = build_wav2vec("tiny", device="cpu")
    proc = AudioProcessor(wav2vec_state_dict=wav2vec_state_dict_from_jax(model, params),
                          wav2vec_config=WAV2VEC_CONFIGS["tiny"], device="cpu",
                          audio_separator_model_path=path)
    got, got_len = proc.preprocess(f"{WAVS}/1.wav", clip_length=16)
    assert proc.separator.calls > 0 and got_len == want_len == 75
    assert got.shape == want.shape == (80, 2, 16)
    np.testing.assert_allclose(got, np.asarray(want), atol=WAV_ATOL)


# -- the synthetic graphs of the published architectures (chip_smoke.py's
# onnx phase runs them at these sizes on the card, the MDX U-Net at
# Kim_Vocal_2's (3072, 256); here it runs at (256, 64)) -----------------------
SYNTHETIC = {
    "scrfd": ("scrfd_graph", {}, (1, 3, 640, 640), 9),
    "arcface": ("arcface_graph", {}, (1, 3, 112, 112), 1),
    "face_mesh": ("face_mesh_graph", {}, (1, 3, 192, 192), 2),
    "mdx_unet": ("mdx_graph", {"dims": (256, 64)}, (1, 4, 256, 64), 1),
    "identity_mdx": ("identity_mdx_graph", {}, (1, 4, 3072, 256), 1),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_graphs_match_jax(tmp_path, name):
    from hallo_tpu_torch.convert import synthetic

    make, kwargs, shape, n_out = SYNTHETIC[name]
    path = getattr(synthetic, make)(str(tmp_path / f"{name}.onnx"), **kwargs)
    feed = {"x": np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)}
    jx = JaxExecutor(path)
    want = {k: np.asarray(v) for k, v in jx.jit()(jx.params, feed).items()}
    got = OnnxExecutor(path, device="cpu")(feed)
    assert sorted(got) == sorted(want) and len(want) == n_out
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert rel_err(got[k].numpy(), want[k]) <= RTOL, (k, rel_err(got[k].numpy(), want[k]))


def test_synthetic_graphs_have_the_published_sizes():
    """The graph functions' defaults are the published architectures: SCRFD-10G
    with keypoints does 10.0 G multiply-adds at 640x480 (the name is its
    count at VGA: 3/4 of its count at 640x640, all of whose feature maps
    halve evenly) with 4.23 M parameters; IResNet-100 has 100 weight layers
    (3x3 convs and the Gemm; the 1x1 shortcuts aside), 12.1 G multiply-adds
    at 112x112 and 65.2 M parameters; the face mesh maps 192x192 to 468 x 3
    through 0.6 M parameters; the TFC-TDF U-Net at Kim_Vocal_2's dims goes
    down 5 levels to 192 channels, 186 G multiply-adds and 10.9 M
    parameters. No file is written."""
    from hallo_tpu_torch.convert import synthetic

    def stats(make, **kw):
        out = {}
        assert getattr(synthetic, make)(None, stats=out, **kw) is None
        return out

    scrfd = stats("scrfd_graph")
    assert abs(scrfd["macs"] * 480 / 640 / 10.0e9 - 1) < 0.01
    assert abs(scrfd["params"] / 4.23e6 - 1) < 0.01
    arc = stats("arcface_graph")
    assert abs(arc["macs"] / 12.1e9 - 1) < 0.01 and abs(arc["params"] / 65.2e6 - 1) < 0.01
    mesh = stats("face_mesh_graph")
    assert abs(mesh["params"] / 0.605e6 - 1) < 0.01
    mdx = stats("mdx_graph")
    assert abs(mdx["macs"] / 185.5e9 - 1) < 0.01 and abs(mdx["params"] / 10.9e6 - 1) < 0.01


def test_iresnet100_has_100_weight_layers(tmp_path):
    """IResNet-100's depth, counted in a graph of its layers at 8 channels
    (the widths do not change the count)."""
    from hallo_tpu_torch.convert import synthetic

    graph = load_onnx(synthetic.arcface_graph(str(tmp_path / "r100.onnx"),
                                              widths=(8, 8, 8, 8))).graph
    inits = graph.initializers
    weight_layers = [n for n in graph.nodes if n.op_type == "Gemm" or (
        n.op_type == "Conv" and inits[n.inputs[1]].shape[2:] == (3, 3))]
    assert len(weight_layers) == 100 and len(graph.outputs) == 1


def test_synthetic_detector_detects_on_the_example_portrait(tmp_path):
    """The SCRFD-10G graph at det 640 on examples/reference_images/1.jpg:
    the port's and JAX's detections are equal, and there are dozens."""
    import cv2

    from hallo_tpu.data.insight_jax import ScrfdJax
    from hallo_tpu_torch.convert import synthetic
    from hallo_tpu_torch.data.insight_torch import ScrfdTorch

    path = synthetic.scrfd_graph(str(tmp_path / "scrfd.onnx"))
    img = cv2.cvtColor(cv2.imread(os.path.join(os.path.dirname(__file__), "..", "examples",
                                               "reference_images", "1.jpg")), cv2.COLOR_BGR2RGB)
    got_boxes, got_kps = ScrfdTorch(path, device="cpu").detect(img)
    want_boxes, want_kps = ScrfdJax(path).detect(img)
    assert 20 <= len(got_boxes) == len(want_boxes)
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(got_kps, want_kps, rtol=RTOL, atol=1e-3)
