"""Web demo around the CLI's inference (counterpart of scripts/app.py;
reference scripts/app.py:18-51).

    python -m hallo_tpu_torch.app [--port 7860] [--device cuda]

With gradio installed it serves gradio's form; without it (the usual case:
the package is not installed) a stdlib HTTP form: GET / gives the upload
form, POST / takes a multipart body with `image` and `audio` files and the
optional fields `pose_weight`, `face_weight`, `lip_weight` and `profile`,
and answers with the rendered mp4. Both call `predict`, which runs the
port's `inference_process` on the card unless `device` says otherwise.
"""

from __future__ import annotations

import argparse
import email
import email.policy
import http.server
import os
import tempfile
from typing import Callable, Optional

PROFILE_INFO = ("exact = DDIM @ 40 steps; fast = UniPC @ 10 grid-nested evals; turbo = "
                "UniPC @ 8 (the port's speed/quality audit: python -m "
                "hallo_tpu_torch.eval_cache_quality)")
OUTPUT = ".cache/output.mp4"


def predict(image_path: str, audio_path: str, pose_weight: float, face_weight: float,
            lip_weight: float, profile: str = "exact", progress=None,
            device: str = "cuda") -> str:
    """Render one video with the CLI's defaults (`build_parser()`), the
    five knobs and the profile; returns the mp4's path."""
    from hallo_tpu_torch.inference import build_parser, inference_process

    args = build_parser().parse_args([])
    args.source_image, args.driving_audio, args.output = image_path, audio_path, OUTPUT
    args.pose_weight, args.face_weight, args.lip_weight = pose_weight, face_weight, lip_weight
    args.face_expand_ratio = 1.2
    args.profile = profile or "exact"
    args.device = device
    return inference_process(args).output


FORM = (b"<html><body><h2>hallo_tpu_torch</h2>"
        b"<form method=post enctype=multipart/form-data>"
        b"image <input type=file name=image><br>"
        b"audio <input type=file name=audio><br>"
        b"pose weight <input name=pose_weight value=1.0><br>"
        b"face weight <input name=face_weight value=1.0><br>"
        b"lip weight <input name=lip_weight value=1.0><br>"
        b"profile <select name=profile><option>exact<option>fast<option>turbo</select><br>"
        b"<input type=submit value=Animate></form></body></html>")


def make_handler(predict_fn: Callable[..., str], device: str):
    """A request handler class whose POST calls `predict_fn`."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(FORM)))
            self.end_headers()
            self.wfile.write(FORM)

        def do_POST(self):
            # the multipart body through the email package (the cgi module
            # is gone from Python 3.13)
            length = int(self.headers.get("Content-Length", 0))
            raw = (f"Content-Type: {self.headers['Content-Type']}\r\n\r\n".encode()
                   + self.rfile.read(length))
            msg = email.message_from_bytes(raw, policy=email.policy.HTTP)
            parts = {p.get_param("name", header="content-disposition"): p.get_payload(decode=True)
                     for p in msg.iter_parts()}
            if "image" not in parts or "audio" not in parts:
                self.send_error(400, "the form needs an image and an audio file")
                return

            def knob(name: str) -> float:
                return float(parts.get(name) or 1.0)

            profile = (parts.get("profile") or b"exact").decode().strip()
            with tempfile.TemporaryDirectory() as tmp:
                img, wav = os.path.join(tmp, "image.jpg"), os.path.join(tmp, "audio.wav")
                with open(img, "wb") as fh:
                    fh.write(parts["image"])
                with open(wav, "wb") as fh:
                    fh.write(parts["audio"])
                out = predict_fn(img, wav, knob("pose_weight"), knob("face_weight"),
                                 knob("lip_weight"), profile=profile, device=device)
            with open(out, "rb") as fh:
                body = fh.read()
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def make_server(port: int, predict_fn: Callable[..., str] = predict, device: str = "cuda",
                host: str = "0.0.0.0") -> http.server.HTTPServer:
    """The stdlib fallback UI's server (not started)."""
    return http.server.HTTPServer((host, port), make_handler(predict_fn, device))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for a host without a card)")
    args = parser.parse_args(argv)
    try:
        import gradio as gr
    except ImportError:
        gr = None
    if gr is None:
        print(f"serving the minimal UI on :{args.port} (gradio not installed)", flush=True)
        with make_server(args.port, device=args.device) as server:
            server.serve_forever()
        return

    def fn(image, audio, pose, face, lip, profile):
        return predict(image, audio, pose, face, lip, profile, device=args.device)

    gr.Interface(
        fn=fn,
        inputs=[
            gr.Image(label="source image (portrait, square)", type="filepath"),
            gr.Audio(label="driving audio (WAV)", type="filepath"),
            gr.Number(label="pose weight", value=1.0),
            gr.Number(label="face weight", value=1.0),
            gr.Number(label="lip weight", value=1.0),
            gr.Dropdown(label="speed profile", choices=["exact", "fast", "turbo"],
                        value="exact", info=PROFILE_INFO),
        ],
        outputs=[gr.Video()],
        title="hallo_tpu_torch: audio-driven portrait animation",
    ).launch(server_port=args.port)


if __name__ == "__main__":
    main()
