"""The serving artifact of the port (`infer/export.py`, `serve_http.py`,
`cli export`) against the JAX package's (`objectdetection_ssd_tpu/infer/
export.py`), on the CPU, with the postprocess of `tests/test_export.py`
(per-class 16, top-k 20, exact top-k) and the same seeded SSD300 weights
through `from_flax_params` (conf-head biases ~ N(0, 3), so that the NMS
has work).

Tolerances, with their reasons:
  * the port's artifact against JAX's artifact on the same images: valid
    masks and classes equal, scores and boxes on the valid rows to 1e-4
    absolute, as `test_torch_detector.py::test_detect_batch_matches_jax`
    (the model outputs differ by ~1e-5: conv summation order);
  * the artifact against the port's live `Detector`, and every pair of
    the port's own artifacts: JAX's gate (`tests/test_export.py:50-57`):
    valid and classes exact, scores rtol 1e-6, boxes rtol 1e-5 / atol
    1e-6; the int8 artifact against the live int8 Detector: bit for bit.
"""

import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from http.server import HTTPServer, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetection_ssd_tpu import config as jconfig
from objectdetection_ssd_tpu.infer import export as jexport
from objectdetection_ssd_tpu.models.ssd import SSD300 as JSSD300
from objectdetection_ssd_torch import cli, serve_http
from objectdetection_ssd_torch import config as tconfig
from objectdetection_ssd_torch.infer import export as texport
from objectdetection_ssd_torch.infer import quant as tquant
from objectdetection_ssd_torch.infer.detector import Detector
from objectdetection_ssd_torch.models.convert import from_flax_params
from objectdetection_ssd_torch.models.ssd import build_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 2

_PP = dict(per_class_top_k=16, top_k=20, use_approx_top_k=False,
           anchor_prefilter=0)
JCFG = jconfig.Config(model=jconfig.ModelConfig(backbone="vgg16"),
                      postprocess=jconfig.PostprocessConfig(**_PP))
TCFG = tconfig.Config(postprocess=tconfig.PostprocessConfig(**_PP))


def _images(input_dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if input_dtype == "uint8":
        return rng.integers(0, 256, (n, 300, 300, 3), dtype=np.uint8)
    return rng.normal(0.0, 0.5, (n, 300, 300, 3)).astype(np.float32)


def _assert_jax_gate(got, want):
    """`tests/test_export.py`'s gate between two detection sets."""
    got = [np.asarray(t) for t in got]
    want = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(got[3], want[3])                # valid
    np.testing.assert_array_equal(got[2], want[2])                # classes
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)        # scores
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def _assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _ops(program) -> dict:
    out = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(
                "ssd."):
            out[str(node.target)] = out.get(str(node.target), 0) + 1
    return out


@pytest.fixture(scope="module")
def params():
    """JAX SSD300 init params with conf-head biases ~ N(0, 3)."""
    p = jax.device_get(jax.jit(JSSD300().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3))))["params"]
    p = jax.tree_util.tree_map(np.array, p)
    rng = np.random.default_rng(0)
    for i in range(6):
        bias = p[f"conf_head_{i}"]["Conv_0"]["bias"]
        bias[...] = rng.normal(0.0, 3.0, bias.shape)
    return p


@pytest.fixture(scope="module")
def state_dict(params):
    return from_flax_params(params)


@pytest.fixture(scope="module", params=["uint8", "float32"])
def artifacts(request, params, state_dict, tmp_path_factory):
    """One JAX and one port artifact at batch 2 for an input dtype."""
    root = tmp_path_factory.mktemp(f"artifacts_{request.param}")
    jdir = jexport.export_detector(JCFG, params, str(root / "jax"),
                                   batch_size=BATCH,
                                   input_dtype=request.param)
    tdir = texport.export_detector(TCFG, state_dict, str(root / "torch"),
                                   batch_size=BATCH,
                                   input_dtype=request.param, device="cpu")
    return {"input_dtype": request.param, "jax_dir": jdir, "dir": tdir,
            "jax": jexport.ExportedDetector(jdir),
            "torch": texport.ExportedDetector(tdir, device="cpu")}


def test_artifact_matches_jax_artifact(artifacts):
    images = _images(artifacts["input_dtype"], BATCH, 1)
    want = jax.device_get(artifacts["jax"](images))
    got = artifacts["torch"](images)
    assert got.boxes_xyxy.shape == (BATCH, 20, 4)
    assert got.boxes_xyxy.device.type == "cpu"
    valid = np.asarray(want.valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-4)
    np.testing.assert_allclose(got.boxes_xyxy.numpy()[valid],
                               np.asarray(want.boxes_xyxy)[valid], atol=1e-4)


def test_artifact_matches_live_detector(artifacts, state_dict):
    images = _images(artifacts["input_dtype"], BATCH, 2)
    live = Detector(TCFG, state_dict, device="cpu").detect_batch(images)
    _assert_jax_gate(artifacts["torch"](images), live)
    # K1 is one node of the program, not the plain recurrence unrolled.
    assert _ops(artifacts["torch"].program) == {"ssd.nms_keep.default": 1}


def test_meta_matches_jax(artifacts):
    with open(os.path.join(artifacts["jax_dir"], "meta.json")) as f:
        want = json.load(f)
    del want["scoped_vmem_limit_kib"]
    assert artifacts["torch"].meta == want
    assert artifacts["torch"].meta["input_dtype"] == artifacts["input_dtype"]


def test_baked_weights_survive_the_round_trip(artifacts, state_dict):
    loaded = artifacts["torch"].program.state_dict
    want = Detector(TCFG, state_dict, device="cpu").model.state_dict()
    assert {k for k in loaded if k.startswith("model.")} == {
        f"model.{k}" for k in want}
    for k, v in want.items():
        assert torch.equal(loaded[f"model.{k}"], v), k


@pytest.mark.parametrize("artifacts", ["uint8"], indirect=True)
def test_pads_short_and_chunks_long_batches(artifacts):
    served = artifacts["torch"]
    with pytest.raises(ValueError, match="empty"):
        served(np.zeros((0, 300, 300, 3), np.uint8))
    imgs = _images("uint8", 5, 3)
    d5 = served(imgs)                       # chunks of 2, 2 and 1 padded
    assert d5.boxes_xyxy.shape == (5, 20, 4)
    pair = served(np.stack([imgs[4], imgs[4]]))
    _assert_jax_gate([t[4:] for t in d5], [t[:1] for t in pair])
    for i in range(4):
        _assert_jax_gate([t[i:i + 1] for t in d5], served(imgs[i:i + 1]))
    with pytest.raises(Exception):
        served(imgs.astype(np.float32))     # the artifact takes uint8


@pytest.mark.parametrize("artifacts", ["uint8"], indirect=True)
def test_format_version_gate(artifacts, tmp_path):
    meta = dict(artifacts["torch"].meta)
    assert meta["format_version"] == texport.FORMAT_VERSION == "1.3"
    texport.check_format_version(meta)
    texport.check_format_version({})           # no version: major 1
    texport.check_format_version({"format_version": "1.3",
                                  "scoped_vmem_limit_kib": 24576})
    with pytest.raises(ValueError, match="format_version"):
        texport.check_format_version({"format_version": "2.0"})
    # On disk: a future major is refused before the program is read.
    future = tmp_path / "future"
    future.mkdir()
    (future / "meta.json").write_text(json.dumps(
        dict(meta, format_version="2.0")))
    with pytest.raises(ValueError, match="format_version"):
        texport.ExportedDetector(str(future), device="cpu")
    # A JAX artifact: same format, no program.pt2; the error names both.
    with pytest.raises(ValueError, match="program.pt2.*program.jaxexport"):
        texport.ExportedDetector(artifacts["jax_dir"], device="cpu")
    empty = tmp_path / "empty"
    shutil.copytree(artifacts["jax_dir"], empty)
    os.remove(empty / "program.jaxexport")
    with pytest.raises(ValueError, match="no program.pt2") as e:
        texport.ExportedDetector(str(empty), device="cpu")
    assert "jaxexport" not in str(e.value)


def test_no_card_raises(artifacts):
    """Without a card, loading or exporting for the default device raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.ExportedDetector(artifacts["dir"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_http.MinimalExportedDetector(artifacts["dir"])


def test_int8_artifact_equals_live_int8_detector(state_dict, tmp_path):
    """A chained int8 artifact (23 K3 nodes, one K1) gives the live int8
    Detector's detections bit for bit."""
    model = build_model(TCFG.model, device="cpu", train=True)
    model.load_state_dict(state_dict)
    images = _images("uint8", 1, 4)
    tree = tquant.chain_scales(tquant.act_scales(
        tquant.calibrate(model, [images])), "vgg16")
    out = texport.export_detector(TCFG, state_dict, str(tmp_path / "q"),
                                  batch_size=1, quant=tree, device="cpu")
    served = texport.ExportedDetector(out, device="cpu")
    assert _ops(served.program) == {"ssd.int8_conv.default": 23,
                                    "ssd.nms_keep.default": 1}
    # The JAX package's count: the scale leaves (`infer/export.py:124`).
    assert served.meta["quantized_convs"] == len(
        jax.tree_util.tree_leaves(tree)) > 23
    live = Detector(TCFG, state_dict, device="cpu", quant=tree)
    got = served(images)
    assert int(got.valid.sum()) > 5
    _assert_bit_equal(got, live.detect_batch(images))


def test_resnet34_tta_artifact_matches_live(tmp_path):
    """A ResNet-34 artifact at batch 1 with flip TTA: the mirrored second
    forward and the anchor pairing are baked in."""
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(backbone="resnet34", image_size=224),
        postprocess=tconfig.PostprocessConfig(**_PP, tta_flip=True))
    sd = build_model(cfg.model, device="cpu",
                     generator=torch.Generator().manual_seed(3)).state_dict()
    for key in ("conf_t4.bias", "conf_t2.bias", "conf_t1.bias"):
        sd[key] = torch.randn(sd[key].shape,
                              generator=torch.Generator().manual_seed(4)) * 3
    out = texport.export_detector(cfg, sd, str(tmp_path / "r34"),
                                  batch_size=1, device="cpu")
    served = texport.ExportedDetector(out, device="cpu")
    assert served.meta["backbone"] == "resnet34"
    assert served.meta["image_size"] == 224
    assert served.meta["tta_flip"] is True
    images = np.random.default_rng(6).integers(0, 256, (1, 224, 224, 3),
                                               dtype=np.uint8)
    live = Detector(cfg, sd, device="cpu")
    assert live.mirror_perm is not None
    got = served(images)
    assert int(got.valid.sum()) > 0
    _assert_jax_gate(got, live.detect_batch(images))


def _int8_args(seed, bias, dtype, requant, stride):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (2, 16, 9, 11), generator=g,
                      dtype=torch.int8).contiguous(
                          memory_format=torch.channels_last)
    w = torch.randint(-127, 128, (8, 3, 3, 16), generator=g,
                      dtype=torch.int8)
    return (x, w, torch.rand(8, generator=g) * 1e-2,
            torch.randn(8, generator=g) if bias else None, stride, 1, 1,
            dtype, torch.tensor(0.05) if requant else None)


@pytest.mark.parametrize("case", [(True, torch.float32, False, 1),
                                  (False, torch.bfloat16, True, 2),
                                  (True, torch.float32, True, 1)],
                         ids=["f32_bias", "bf16_int8_stride2", "f32_int8"])
def test_int8_conv_op_passes_opcheck(case):
    """The fake's shape, dtype and strides (channels_last) are the real
    op's; the schema holds the optional tensors and scalars."""
    args = _int8_args(0, *case)
    torch.library.opcheck(torch.ops.ssd.int8_conv.default, args)
    assert args[0].shape[0] == 2
    out = torch.ops.ssd.int8_conv(*args)
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_nms_keep_op_passes_opcheck():
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand(2, 20, 16, 4, generator=g)
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.rand(2, 20, 16, generator=g) > 0.3
    torch.library.opcheck(torch.ops.ssd.nms_keep.default,
                          (boxes, valid, 0.45))


@pytest.mark.parametrize("artifacts", ["uint8"], indirect=True)
def test_micro_batcher_coalesces_and_matches(artifacts):
    """Concurrent requests share program calls (a batch of 2 and one
    padded), and each caller gets the rows of a direct call."""
    det = serve_http.MinimalExportedDetector(artifacts["dir"], device="cpu")
    images = _images("uint8", 3, 7)
    want = []
    for img in images:
        out = det(np.broadcast_to(img, (BATCH, 300, 300, 3)).copy())
        want.append([t[0].numpy() for t in out])
    batcher = serve_http.MicroBatcher(det, max_wait_ms=200.0)
    results = [None] * len(images)

    def call(i):
        results[i] = batcher.infer_one(images[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(images))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    for got, w in zip(results, want):
        _assert_jax_gate(got, w)


def test_micro_batcher_fans_out_failures():
    class Boom:
        meta = {"batch_size": 4}

        def __call__(self, images):
            raise RuntimeError("boom")

    batcher = serve_http.MicroBatcher(Boom(), max_wait_ms=50.0)
    errs = [None, None]

    def call(i):
        try:
            batcher.infer_one(np.zeros((8, 8, 3), np.float32))
        except RuntimeError as e:
            errs[i] = str(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive(), "caller hung on a failed batch"
    batcher.close()
    assert errs == ["boom", "boom"]


def _post(port: int, payload: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/detect",
                                 data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def _jpeg(seed: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (120, 160, 3), np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("artifacts", ["uint8"], indirect=True)
@pytest.mark.parametrize("dynamic", [False, True], ids=["direct", "batched"])
def test_http_serving(artifacts, dynamic):
    """The server answers /detect over a real socket from the artifact
    alone, per request or through the MicroBatcher (2 concurrent
    clients)."""
    det = serve_http.MinimalExportedDetector(artifacts["dir"], device="cpu")
    batcher = (serve_http.MicroBatcher(det, max_wait_ms=50.0) if dynamic
               else None)
    handler = serve_http.build_handler(det, det.meta["classes"],
                                       batcher=batcher)
    server = (ThreadingHTTPServer if dynamic else HTTPServer)(
        ("127.0.0.1", 0), handler)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    outs = [None, None]
    try:
        def post(i):
            outs[i] = _post(port, _jpeg(i))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(2 if dynamic else 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for status, payload in outs[:len(threads)]:
            assert status == 200
            for d in payload["detections"]:
                assert set(d) == {"box_xyxy", "label", "score"}
                assert d["label"] in tconfig.VOC_CLASSES
                assert 0.2 <= d["score"] <= 1.0
        assert any(p["detections"] for _, p in outs[:len(threads)])
    finally:
        server.shutdown()
        server.server_close()
        if batcher is not None:
            batcher.close()


def test_cli_export_latency_profile_then_exported_detector(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """`export --latency-profile` calibrates on the train split, exports a
    batch-1 int8 artifact with 32 candidates per class, and
    `ExportedDetector` serves it; without `--device cpu` it raises."""
    from objectdetection_ssd_torch.data import synthetic
    monkeypatch.chdir(tmp_path)
    synthetic.generate_voc("VOCdevkit", num_2007=4, num_2012=0,
                           image_size=(96, 80), seed=1)
    argv = ["export", "--out-dir", "art", "--latency-profile",
            "--allow-random-init", "--checkpoint-dir", "none",
            "--voc-root", "VOCdevkit", "--int8-calib-images", "1",
            "--num-workers", "0"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "exported serving artifact -> art" in out
    assert "int8: calibrated 23 convs on 1 images" in err
    served = texport.ExportedDetector("art", device="cpu")
    assert served.meta["batch_size"] == 1
    assert served.meta["quantized_convs"] > 23
    assert _ops(served.program)["ssd.int8_conv.default"] == 23
    image = np.zeros((1, 300, 300, 3), np.uint8)
    assert served(image).boxes_xyxy.shape == (1, 200, 4)


@pytest.mark.parametrize("artifacts", ["uint8"], indirect=True)
def test_loaders_import_no_model_code(artifacts):
    """In a fresh interpreter, `ExportedDetector` and the server load and
    run the artifact without importing a module of `models/`."""
    code = (
        "import sys, numpy as np\n"
        "from objectdetection_ssd_torch.infer.export import ExportedDetector\n"
        "from objectdetection_ssd_torch import serve_http\n"
        f"d = ExportedDetector({artifacts['dir']!r}, device='cpu')\n"
        "x = np.zeros((1, 300, 300, 3), np.uint8)\n"
        "assert d(x).valid.shape == (1, 20)\n"
        f"m = serve_http.MinimalExportedDetector({artifacts['dir']!r}, "
        "device='cpu')\n"
        "assert m(np.concatenate([x, x]))[3].shape == (2, 20)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith('objectdetection_ssd_torch.models'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

