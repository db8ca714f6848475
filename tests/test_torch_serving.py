"""The port's serving engine and HTTP handler against the JAX engine.

Same bridged TINY weights and frames through both `process_array`s:
captions and ids exact, boxes and scores within 1e-4 (accumulation order
differs between XLA:CPU and torch; boxes are in original-image pixels).
"""

import base64
import http.client
import io
import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densecap_tpu.config import DenseCapConfig as JaxConfig
from densecap_tpu.models import densecap as jd
from densecap_tpu.serve.engine import InferenceEngine as JaxEngine
from densecap_tpu.serve.engine import TemporalSmoother as JaxSmoother
from densecap_tpu_torch.config import DenseCapConfig
from densecap_tpu_torch.serve import server as port_server
from densecap_tpu_torch.serve.engine import InferenceEngine, TemporalSmoother
from densecap_tpu_torch.utils.image import to_model_input

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(vocab_size=12, seq_length=4, image_size=64,
            anchors=((8, 8), (16, 16), (12, 24), (24, 12)),
            test_max_proposals=8, rnn_size=16, rnn_encoding_size=16,
            fc_dim=32, rpn_num_filters=16)
JCFG = JaxConfig(**TINY, sampler_batch_size=8, max_gt_boxes=4,
                 compute_dtype=jnp.float32)
PCFG = DenseCapConfig(**TINY, compute_dtype=torch.float32)
IDX_TO_TOKEN = {i: f"w{i}" for i in range(1, 13)}


def _frames(n=3):
    rng = np.random.default_rng(0)
    shapes = [(100, 80), (64, 64), (50, 90), (70, 70)]
    return [rng.integers(0, 256, (*shapes[i % 4], 3), dtype=np.uint8)
            for i in range(n)]


@pytest.fixture(scope="module")
def params():
    p = jd.init_params(jax.random.PRNGKey(0), JCFG)
    return p, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def jax_results(params):
    eng = JaxEngine(params[0], JCFG, IDX_TO_TOKEN, max_boxes=5)
    return [eng.process_array(f, stream_id=str(i))
            for i, f in enumerate(_frames())]


def _same(got, ref):
    assert got["captions"] == ref["captions"]
    assert got["ids"] == ref["ids"]
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_engine_matches_jax_engine(params, jax_results, batch_size):
    eng = InferenceEngine(params[1], PCFG, IDX_TO_TOKEN, device="cpu",
                          max_boxes=5, batch_size=batch_size)
    try:
        with ThreadPoolExecutor(3) as ex:  # concurrent: batches form
            got = list(ex.map(lambda i: eng.process_array(
                _frames()[i], stream_id=str(i)), range(3)))
    finally:
        eng.close()
    assert all(0 < len(g["boxes"]) <= 5 for g in got)
    for g, r in zip(got, jax_results):
        _same(g, r)


def test_batch_error_reaches_every_request(params):
    eng = InferenceEngine(params[1], PCFG, IDX_TO_TOKEN, device="cpu",
                          smoothing=False, batch_size=2,
                          request_timeout_s=30)

    def broken(*a, **k):
        raise ValueError("boom")

    eng.model.forward_test_batch = broken
    try:
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(eng.process_array, f) for f in _frames(2)]
            for f in futs:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=60)
    finally:
        eng.close()
    assert not any(t.is_alive() for t in eng._threads)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_thin_frame_answered_as_jax_engine_does(params, jax_results,
                                                batch_size):
    # 2000x30 scales to 64x1 on the tiny canvas: no feature column, so no
    # anchor is valid and the JAX engine answers with no regions; the
    # good frame in the same batch is answered as before
    thin = np.zeros((2000, 30, 3), np.uint8)
    ref = JaxEngine(params[0], JCFG, IDX_TO_TOKEN, max_boxes=5
                    ).process_array(thin, stream_id="thin")
    assert ref == {"boxes": [], "scores": [], "captions": [], "ids": []}
    eng = InferenceEngine(params[1], PCFG, IDX_TO_TOKEN, device="cpu",
                          max_boxes=5, batch_size=batch_size,
                          request_timeout_s=60)
    try:
        with ThreadPoolExecutor(2) as ex:
            bad = ex.submit(eng.process_array, thin, stream_id="thin")
            good = ex.submit(eng.process_array, _frames()[0], stream_id="0")
            assert bad.result(timeout=60) == ref
            _same(good.result(timeout=60), jax_results[0])
    finally:
        eng.close()


@pytest.mark.parametrize("hw", [(15, 64), (64, 15), (0, 64), (64, 1)])
def test_to_model_input_accepts_sizes_without_features(hw):
    canvas = np.zeros((64, 64, 3), np.uint8)
    x, h, w = to_model_input([canvas], [hw[0]], [hw[1]], "cpu")
    assert x.shape == (1, 64, 64, 3)
    assert (float(h[0]), float(w[0])) == hw


@pytest.mark.parametrize("hw", [(65, 64), (64, 65)])
def test_to_model_input_rejects_sizes_off_the_canvas(hw):
    canvas = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="fit the canvas"):
        to_model_input([canvas], [hw[0]], [hw[1]], "cpu")


def test_frame_that_rounds_to_zero_px_raises_as_jax():
    # 2000x1 scales to 64x0: PIL refuses the resize in both packages
    from densecap_tpu.utils.image import preprocess_for_model_uint8 as jpre
    from densecap_tpu_torch.utils.image import preprocess_for_model_uint8

    rgb = np.zeros((2000, 1, 3), np.uint8)
    for fn in (jpre, preprocess_for_model_uint8):
        with pytest.raises(ValueError, match="must be > 0"):
            fn(rgb, 64)


def test_smoother_matches_jax_and_touches_no_torch():
    rng = np.random.default_rng(5)
    port, ref = TemporalSmoother(), JaxSmoother()

    class NoTorch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            raise AssertionError(f"torch call on the smoother path: {func}")

    with NoTorch():
        with pytest.raises(AssertionError):  # the guard is live
            torch.zeros(1) + 1
        base = rng.uniform(10, 90, (6, 4))
        for _ in range(5):
            boxes = base + rng.normal(0, 2, base.shape)
            boxes = boxes[rng.permutation(6)[:rng.integers(2, 7)]]
            np.testing.assert_array_equal(port.assign_ids(boxes),
                                          ref.assign_ids(boxes))


def _post(port, body, ctype):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/infer",
                                 data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_http_handler_roundtrip(params, tmp_path, monkeypatch):
    from PIL import Image

    static = tmp_path / "static"
    static.mkdir()
    (static / "client.html").write_text("<title>DenseCap</title>")
    (tmp_path / "static_private").mkdir()
    (tmp_path / "static_private" / "key.txt").write_text("secret")
    monkeypatch.setattr(port_server, "_STATIC_DIR", str(static))

    eng = InferenceEngine(params[1], PCFG, IDX_TO_TOKEN, device="cpu",
                          max_boxes=5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                port_server.make_handler(eng))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(_frames()[0]).save(buf, format="JPEG")
        payload = json.dumps({
            "image": "data:image/jpeg;base64,"
                     + base64.b64encode(buf.getvalue()).decode(),
            "stream": "a"}).encode()
        out = _post(port, payload, "application/json")
        assert set(out) == {"boxes", "scores", "captions", "ids"}
        assert 0 < len(out["boxes"]) <= 5
        raw = _post(port, buf.getvalue(), "image/jpeg")
        np.testing.assert_allclose(raw["boxes"], out["boxes"])

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as resp:
            assert b"DenseCap" in resp.read()
        # a sibling directory sharing the static dir's prefix stays private
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/../static_private/key.txt")
        assert conn.getresponse().status == 404
        conn.close()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, b"not an image", "image/jpeg")
        assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
