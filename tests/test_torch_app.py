"""The port's demo (`hallo_tpu_torch/app.py`) on the CPU:

- the stdlib server's multipart handler on a free port, in a thread, with
  `predict` stubbed: the uploaded files reach it byte for byte with the
  knobs and the profile, and the rendered file comes back as video/mp4; the
  GET form; a body without the audio file is refused with 400;
- `predict` builds the CLI's namespace as scripts/app.py's does (the same
  config, inputs, output, knobs, face_expand_ratio and profile), from the
  port's `build_parser()` defaults plus the device;
- the profile help states no TPU figure (scripts/app.py:55-56 states
  BASELINE.md's 29.3 dB and 3.4x, measured on a TPU).
"""

import email.message
import http.client
import threading

import pytest

from hallo_tpu_torch import app
from hallo_tpu_torch import inference


def multipart(fields: dict) -> tuple:
    """(body bytes, Content-Type header) of a multipart/form-data form."""
    msg = email.message.EmailMessage()
    for name, value in fields.items():
        if isinstance(value, bytes):
            msg.add_attachment(value, maintype="application", subtype="octet-stream",
                               disposition="form-data", filename=name)
        else:
            msg.add_attachment(value, disposition="form-data")
        part = list(msg.iter_parts())[-1]
        part.set_param("name", name, header="content-disposition")
    msg.set_param("boundary", "hallo-test-boundary")
    raw = msg.as_bytes(policy=msg.policy.clone(linesep="\r\n"))
    body = raw.split(b"\r\n\r\n", 1)[1]
    return body, "multipart/form-data; boundary=hallo-test-boundary"


@pytest.fixture
def server(tmp_path):
    calls = []
    video = tmp_path / "out.mp4"
    video.write_bytes(b"\x00\x00\x00\x18ftypmp42 rendered video")

    def predict(image, audio, pose, face, lip, profile="exact", device="cuda"):
        with open(image, "rb") as fh_i, open(audio, "rb") as fh_a:
            calls.append(dict(image=fh_i.read(), audio=fh_a.read(), knobs=(pose, face, lip),
                              profile=profile, device=device))
        return str(video)

    srv = app.make_server(0, predict, device="cpu", host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1], calls, video.read_bytes()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def request(port: int, method: str, body: bytes = b"", ctype: str = ""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        headers = {"Content-Type": ctype, "Content-Length": str(len(body))} if body else {}
        conn.request(method, "/", body=body or None, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_multipart_post_calls_predict(server):
    port, calls, video = server
    image, audio = b"\xff\xd8\xff\xe0 jpeg bytes \r\n--x", b"RIFF\x00\x01 wav bytes"
    body, ctype = multipart(dict(image=image, audio=audio, pose_weight="0.5",
                                 lip_weight="1.5", profile="turbo"))
    status, got_type, got = request(port, "POST", body, ctype)
    assert (status, got_type, got) == (200, "video/mp4", video)
    assert calls == [dict(image=image, audio=audio, knobs=(0.5, 1.0, 1.5), profile="turbo",
                          device="cpu")]
    # without the optional fields: the knobs at 1 and the exact profile
    body, ctype = multipart(dict(image=image, audio=audio))
    assert request(port, "POST", body, ctype)[0] == 200
    assert calls[-1]["knobs"] == (1.0, 1.0, 1.0) and calls[-1]["profile"] == "exact"


def test_get_form_and_bad_post(server):
    port, calls, _ = server
    status, ctype, page = request(port, "GET")
    assert status == 200 and ctype == "text/html"
    assert b"name=image" in page and b"name=audio" in page and b"name=profile" in page
    body, ctype = multipart(dict(image=b"jpeg"))
    assert request(port, "POST", body, ctype)[0] == 400
    assert calls == []


def test_predict_namespace_matches_jax(monkeypatch):
    import scripts.inference as jax_cli
    from scripts import app as jax_app

    seen = {}

    class Run:
        output = "out.mp4"

    def port_process(args):
        seen["port"] = args
        return Run()

    def jax_process(args):
        seen["jax"] = args
        return "out.mp4"

    monkeypatch.setattr(inference, "inference_process", port_process)
    monkeypatch.setattr(jax_cli, "inference_process", jax_process)
    assert app.predict("i.jpg", "a.wav", 0.7, 0.8, 0.9, "fast", device="cpu") == "out.mp4"
    assert jax_app.predict("i.jpg", "a.wav", 0.7, 0.8, 0.9, "fast") == "out.mp4"
    port, want = vars(seen["port"]), vars(seen["jax"])
    assert {k: port[k] for k in want} == want
    defaults = vars(inference.build_parser().parse_args([]))
    assert set(port) == set(defaults)
    assert port["device"] == "cpu" and port["allow_partial"] is False
    app.predict("i.jpg", "a.wav", 1.0, 1.0, 1.0, None, device="cpu")
    assert seen["port"].profile == "exact"


def test_profile_help_states_no_tpu_figure():
    assert "dB" not in app.PROFILE_INFO and "3.4x" not in app.PROFILE_INFO
    for name in ("exact", "fast", "turbo"):
        assert name in app.PROFILE_INFO
