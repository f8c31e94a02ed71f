"""HTTP layer: a stdlib ThreadingHTTPServer over ``VfpService`` (port of
``vfp_tpu/serve/app.py``, the same routes, status codes, headers and
content types).

Endpoints:
    GET  /                 -> upload page
    GET  /upload           -> upload page
    POST /upload           -> process a video (multipart 'file': .rawv, MJPEG
                              .avi/.mp4/.m4s or .y4m; with an ffmpeg binary
                              on PATH, any container its pipe reads)
    POST /start-view       -> JSON {username, num_copies?} -> view session
    GET  /view             -> player page
    GET  /view/{view_id}   -> per-view m3u8
    GET  /hls/{filename}   -> segment/playlist files (CORS + no-cache)
    GET  /download-view/{view_id} -> the view's spliced video (.mp4 with the
                              upload's audio, or the variants' own container)
    POST /detect           -> multipart leaked segment -> matching usernames
    GET  /view-history     -> JSON

Marking and detection run on the service's device (``make_server(...,
device="cuda")`` by default, raising without a GPU).
"""

from __future__ import annotations

import json
import logging
import re
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from .service import VfpService
from .templates import render_page

logger = logging.getLogger(__name__)

_CRLF2 = b"\r\n\r\n"
_STRIP = b"\r\n"


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser: returns {name: (filename, bytes)}.

    The JAX package's parser split the body at every delimiter and stripped
    CR and LF bytes off both ends of each part, copying a 1 GB upload three
    or four times; this one finds the same offsets in place and slices each
    field's data once, with the same result, stripped bytes included."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    delim = b"--" + m.group(1).encode()
    out = {}
    start = 0
    while start <= len(body):
        end = body.find(delim, start)
        if end < 0:
            end = len(body)
        s, e = start, end
        while s < e and body[s] in _STRIP:
            s += 1
        while e > s and body[e - 1] in _STRIP:
            e -= 1
        closing = e - s == 2 and body[s:e] == b"--"  # the "--" after the last delimiter
        sep = -1 if closing else body.find(_CRLF2, s, e)
        if sep >= 0:
            head_text = body[s:sep].decode("utf-8", "replace")
            name_m = re.search(r'name="([^"]*)"', head_text)
            file_m = re.search(r'filename="([^"]*)"', head_text)
            if name_m:
                out[name_m.group(1)] = (file_m.group(1) if file_m else None, body[sep + 4: e])
        start = end + len(delim)
    return out


def make_handler(service: VfpService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s %s", self.address_string(), fmt % args)

        # -- helpers -------------------------------------------------------
        def _send(self, code: int, body: bytes, ctype: str, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _html(self, text: str, code: int = 200):
            self._send(code, text.encode(), "text/html; charset=utf-8")

        def _read_body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _with_upload(self, parts, default_name: str, fn):
            """Write the 'file' field to a temporary file in the service's
            data dir (an upload can be a gigabyte), answer with
            ``fn(path)``: 400 for a missing field or an unreadable file."""
            if "file" not in parts:
                return self._json({"detail": "file field required"}, 400)
            fname, data = parts["file"]
            suffix = Path(fname or default_name).suffix or ".mp4"
            with tempfile.NamedTemporaryFile(suffix=suffix, dir=service.data_dir,
                                             delete=False) as f:
                f.write(data)
                tmp = f.name
            try:
                return self._json(fn(tmp))
            except OSError as e:  # undecodable/corrupt media is a client error
                return self._json({"detail": str(e)}, 400)
            finally:
                Path(tmp).unlink(missing_ok=True)

        # -- GET -------------------------------------------------------------
        def do_GET(self):
            try:
                path = self.path.split("?")[0]
                if path in ("/", "/upload"):
                    return self._html(render_page("upload"))
                if path == "/view":
                    return self._html(render_page("view"))
                if path == "/detect":
                    return self._html(render_page("detect"))
                if path == "/view-history":
                    return self._json(service.view_history())
                if path.startswith("/view/"):
                    view_id = path[len("/view/"):]
                    try:
                        m3u8 = service.view_playlist(view_id)
                    except KeyError:
                        return self._json({"error": "view not found"}, 404)
                    return self._send(
                        200, m3u8.encode(), "application/vnd.apple.mpegurl",
                        {"Cache-Control": "no-cache"},
                    )
                if path.startswith("/hls/"):
                    name = Path(path[len("/hls/"):]).name
                    f = service.hls_dir / name
                    if not f.exists():
                        return self._json({"error": "not found"}, 404)
                    data = f.read_bytes()
                    ctype = (
                        "application/vnd.apple.mpegurl"
                        if name.endswith(".m3u8")
                        else "video/mp4" if name.endswith((".m4s", ".mp4"))
                        else "application/octet-stream"
                    )
                    return self._send(200, data, ctype, {"Cache-Control": "no-cache"})
                if path.startswith("/download-view/"):
                    view_id = path[len("/download-view/"):]
                    try:
                        f = service.download_view(view_id)
                    except KeyError:
                        return self._json({"error": "view not found"}, 404)
                    return self._send(
                        200, f.read_bytes(), "video/mp4",
                        {"Content-Disposition": f'attachment; filename="{f.name}"'},
                    )
                return self._json({"error": "not found"}, 404)
            except Exception as e:
                logger.exception("GET %s failed", self.path)
                return self._json({"error": str(e)}, 500)

        # -- POST --------------------------------------------------------------
        def do_POST(self):
            try:
                path = self.path.split("?")[0]
                body = self._read_body()
                parts = None
                if path in ("/upload", "/detect"):
                    try:
                        parts = parse_multipart(body, self.headers.get("Content-Type", ""))
                    except ValueError as e:  # no/garbled boundary: client error
                        return self._json({"detail": str(e)}, 400)
                if path == "/start-view":
                    data = json.loads(body or b"{}")
                    try:
                        return self._json(
                            service.start_view(data.get("username"), data.get("num_copies"))
                        )
                    except ValueError as e:
                        return self._json({"detail": str(e)}, 400)
                    except FileNotFoundError as e:
                        return self._json({"detail": str(e)}, 404)
                if path == "/upload":
                    return self._with_upload(parts, "upload.mp4", service.process_upload)
                if path == "/detect":
                    return self._with_upload(parts, "leaked.mp4", service.detect)
                return self._json({"error": "not found"}, 404)
            except Exception as e:
                logger.exception("POST %s failed", self.path)
                return self._json({"error": str(e)}, 500)

    return Handler


def make_server(host: str, port: int, data_dir, *, device="cuda", **kw) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer over a ``VfpService(data_dir, device=device, **kw)``."""
    service = VfpService(data_dir, device=device, **kw)
    return ThreadingHTTPServer((host, port), make_handler(service))


def run_server(host: str = "0.0.0.0", port: int = 8000, data_dir: str = "serve_data", **kw):
    srv = make_server(host, port, data_dir, **kw)
    logger.info("serving on http://%s:%d (data dir %s)", host, port, data_dir)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        srv.server_close()
