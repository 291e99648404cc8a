"""DVIDClient against a local mock HTTP server (no network egress)."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from flypylib_tpu.io.dvid import DVIDClient
from flypylib_tpu.io.synapses import Tbars


class MockDVID(BaseHTTPRequestHandler):
    volume = None  # (z, y, x) uint8, set by fixture
    posted = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        # /api/node/{uuid}/{instance}/raw/0_1_2/{sx}_{sy}_{sz}/{ox}_{oy}_{oz}
        if "raw" in parts:
            i = parts.index("raw")
            sx, sy, sz = map(int, parts[i + 2].split("_"))
            ox, oy, oz = map(int, parts[i + 3].split("_"))
            cut = self.volume[oz : oz + sz, oy : oy + sy, ox : ox + sx]
            data = np.ascontiguousarray(cut).tobytes()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif "elements" in parts:
            els = [
                {"Kind": "PreSyn", "Pos": [3, 2, 1], "Prop": {"conf": "0.75"}}
            ]
            data = json.dumps(els).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self.send_response(404)
            self.end_headers()

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        MockDVID.posted.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()


@pytest.fixture
def mock_server():
    rng = np.random.default_rng(0)
    MockDVID.volume = rng.integers(0, 256, (16, 20, 24)).astype(np.uint8)
    MockDVID.posted = []
    srv = HTTPServer(("127.0.0.1", 0), MockDVID)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_port}", MockDVID
    srv.shutdown()


def test_get_gray3d(mock_server):
    addr, mock = mock_server
    client = DVIDClient(addr, "abc123")
    cut = client.get_gray3d("grayscale", size=(8, 10, 12), offset=(2, 3, 4))
    assert cut.shape == (8, 10, 12)
    np.testing.assert_array_equal(
        cut, mock.volume[2:10, 3:13, 4:16]
    )


def test_get_annotations(mock_server):
    addr, _ = mock_server
    client = DVIDClient(addr, "abc123")
    tb = client.get_annotations("synapses", size=(16, 20, 24), offset=(0, 0, 0))
    assert len(tb) == 1
    np.testing.assert_array_equal(tb.locs[0], [1, 2, 3])  # zyx of Pos [3,2,1]
    assert tb.conf[0] == 0.75


def test_post_annotations(mock_server):
    addr, mock = mock_server
    client = DVIDClient(addr, "abc123")
    client.post_annotations(
        "synapses", Tbars(locs=[[5, 6, 7]], conf=[0.5])
    )
    assert len(mock.posted) == 1
    el = mock.posted[0][0]
    assert el["Kind"] == "PreSyn"
    assert el["Pos"] == [7, 6, 5]


class StatefulDVID(MockDVID):
    """Stores POSTed elements and serves them back on GET (upsert-free
    round-trip store, enough to pin push-then-fetch parity)."""

    elements = []

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        if "elements" in parts:
            data = json.dumps(StatefulDVID.elements).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            super().do_GET()

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        StatefulDVID.elements.extend(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()


def test_post_annotations_partner_roundtrip():
    """Push detections WITH partner PSDs, read back an identical Tbars
    (locs + conf + partners)."""
    StatefulDVID.elements = []
    srv = HTTPServer(("127.0.0.1", 0), StatefulDVID)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = DVIDClient(f"127.0.0.1:{srv.server_port}", "abc123")
        tb = Tbars(
            locs=[[5, 6, 7], [9, 9, 9]],
            conf=[0.5, 0.75],
            partners=[[[5, 6, 10], [8, 6, 7]], np.zeros((0, 3))],
        )
        client.post_annotations("synapses", tb)
        back = client.get_annotations(
            "synapses", size=(16, 16, 16), offset=(0, 0, 0)
        )
        np.testing.assert_array_equal(back.locs, tb.locs)
        np.testing.assert_allclose(back.conf, tb.conf)
        np.testing.assert_array_equal(back.partners[0], tb.partners[0])
        assert back.partners[1].shape == (0, 3)
    finally:
        srv.shutdown()


class FlakyDVID(MockDVID):
    """First two requests 503, then defer to the real handlers."""

    failures = [2]

    def _maybe_fail(self):
        if FlakyDVID.failures[0] > 0:
            FlakyDVID.failures[0] -= 1
            self.send_response(503)
            self.end_headers()
            return True
        return False

    def do_GET(self):
        if not self._maybe_fail():
            super().do_GET()

    def do_POST(self):
        if not self._maybe_fail():
            super().do_POST()


@pytest.fixture
def flaky_server():
    rng = np.random.default_rng(1)
    FlakyDVID.volume = rng.integers(0, 256, (8, 8, 8)).astype(np.uint8)
    FlakyDVID.posted = []
    FlakyDVID.failures = [2]
    srv = HTTPServer(("127.0.0.1", 0), FlakyDVID)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_port}", FlakyDVID
    srv.shutdown()


def test_retry_on_transient_5xx(flaky_server):
    addr, mock = flaky_server
    client = DVIDClient(addr, "abc123", retries=3, backoff=0.01)
    cut = client.get_gray3d("grayscale", size=(4, 4, 4), offset=(0, 0, 0))
    np.testing.assert_array_equal(cut, mock.volume[:4, :4, :4])


def test_no_retry_on_permanent_404(mock_server):
    import urllib.error

    addr, _ = mock_server
    client = DVIDClient(addr, "abc123", retries=3, backoff=0.01)
    with pytest.raises(urllib.error.HTTPError):
        client._get(client._url("nope", "bogus/endpoint"))


class GzipDVID(MockDVID):
    def do_GET(self):
        import gzip as _gz

        els = [{"Kind": "PreSyn", "Pos": [1, 1, 1], "Prop": {"conf": "0.5"}}]
        data = _gz.compress(json.dumps(els).encode())
        self.send_response(200)
        self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def test_gzip_transfer():
    srv = HTTPServer(("127.0.0.1", 0), GzipDVID)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = DVIDClient(f"127.0.0.1:{srv.server_port}", "abc123")
        tb = client.get_annotations("synapses", size=(8, 8, 8),
                                    offset=(0, 0, 0))
        assert len(tb) == 1 and tb.conf[0] == 0.5
    finally:
        srv.shutdown()


def test_dvid_reader_streaming_detection(mock_server):
    """detect_streaming straight from a DVID node (dvid_reader) ==
    the same detection on the in-RAM array — each ROI window is one
    /raw cutout GET, never the whole volume in host RAM."""
    import jax
    import jax.numpy as jnp

    from flypylib_tpu.infer.large import (
        array_reader,
        detect_streaming,
        dvid_reader,
    )
    from flypylib_tpu.models.zoo import baseline_model

    addr, mock = mock_server
    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    client = DVIDClient(addr, "abc123")

    shape, read = dvid_reader(client, "grayscale", mock.volume.shape)
    common = dict(core=8, tile_out=8, window=3, threshold=0.6,
                  max_detections_per_roi=512)
    got = detect_streaming(spec, variables, shape, read, **common)
    ashape, aread = array_reader(mock.volume)
    want = detect_streaming(spec, variables, ashape, aread, **common)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.locs, want.locs)
    np.testing.assert_allclose(got.conf, want.conf)

    # offset windows slice the same box the array reader would
    shape2, read2 = dvid_reader(client, "grayscale", (8, 10, 12),
                                offset=(2, 3, 4))
    np.testing.assert_array_equal(
        read2((0, 0, 0), shape2), mock.volume[2:10, 3:13, 4:16]
    )
