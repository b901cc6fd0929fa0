"""Minimal asyncio HTTP/1.1 framework — the framework's own runtime.

Port of ``ocr_system_tpu/api/http.py``: the same code, on the port's modules.

Plays the role FastAPI+uvicorn play in the reference (backend/main.py): a
routed, middleware-wrapped, JSON-speaking HTTP server — but first-party and
stdlib-only, sized to what the OCR system needs:

  - Router with path parameters ("/api/documents/{document_id}")
  - JSON + multipart/form-data request parsing (file uploads)
  - Response helpers incl. streaming file responses
  - Middleware chain (rate limiting, timing — api/middleware.py)
  - BackgroundTasks executed after the response is flushed (the reference's
    upload->202->background-extract pattern, documents.py:284-290)
  - Structured error responses ({"detail": ...}, FastAPI-compatible shape so
    the reference frontend/clients parse errors unchanged)
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qs, unquote

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024  # hard cap; route-level limits are tighter


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclass
class UploadFile:
    filename: str
    content_type: str
    data: bytes


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    path_params: dict[str, str] = field(default_factory=dict)
    client_ip: str = ""

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except ValueError:
            raise HTTPError(422, "Malformed JSON body")

    def form(self) -> tuple[dict[str, str], dict[str, UploadFile]]:
        """Parse multipart/form-data -> (fields, files)."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if "multipart/form-data" not in ctype or not m:
            raise HTTPError(422, "Expected multipart/form-data body")
        boundary = m.group(1).encode()
        fields: dict[str, str] = {}
        files: dict[str, UploadFile] = {}
        # RFC 2046: parts are delimited by CRLF "--" boundary; only that one
        # delimiter CRLF may be removed — payload bytes that legitimately
        # start/end with 0x0A/0x0D (TIFFs, PDFs with trailing newlines) must
        # survive intact.
        delimiter = b"--" + boundary
        body = self.body
        if body.startswith(delimiter):  # first delimiter has no leading CRLF
            body = b"\r\n" + body
        segments = body.split(b"\r\n" + delimiter)
        for seg in segments[1:]:  # segments[0] is the RFC 2046 preamble
            if seg.startswith(b"--"):  # closing delimiter "--boundary--"
                break
            nl = seg.find(b"\r\n")  # end of the boundary line (after padding)
            if nl == -1:
                continue
            part = seg[nl + 2 :]
            if b"\r\n\r\n" not in part:
                continue
            head, data = part.split(b"\r\n\r\n", 1)
            disp = ""
            part_ctype = "application/octet-stream"
            for line in head.decode("latin-1").split("\r\n"):
                lower = line.lower()
                if lower.startswith("content-disposition:"):
                    disp = line
                elif lower.startswith("content-type:"):
                    part_ctype = line.split(":", 1)[1].strip()
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1)
            if file_m:
                files[name] = UploadFile(
                    filename=file_m.group(1), content_type=part_ctype, data=data
                )
            else:
                fields[name] = data.decode("utf-8", errors="replace")
        return fields, files


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    @classmethod
    def json(cls, data: Any, status: int = 200, headers: dict | None = None):
        return cls(
            status=status,
            headers={"Content-Type": "application/json", **(headers or {})},
            body=json.dumps(data, ensure_ascii=False, default=str).encode(),
        )

    @classmethod
    def file(cls, path: str | Path, content_type: str, filename: str | None = None):
        p = Path(path)
        if not p.is_file():
            raise HTTPError(404, "File not found")
        headers = {"Content-Type": content_type}
        if filename:
            headers["Content-Disposition"] = f'attachment; filename="{filename}"'
        return cls(status=200, headers=headers, body=p.read_bytes())

    @classmethod
    def text(cls, text: str, status: int = 200, content_type: str = "text/plain"):
        return cls(
            status=status,
            headers={"Content-Type": f"{content_type}; charset=utf-8"},
            body=text.encode(),
        )


class BackgroundTasks:
    """Callables run after the response is sent (reference BackgroundTasks)."""

    def __init__(self):
        self.tasks: list[tuple[Callable, tuple, dict]] = []

    def add_task(self, fn: Callable, *args, **kwargs) -> None:
        self.tasks.append((fn, args, kwargs))

    async def run(self) -> None:
        for fn, args, kwargs in self.tasks:
            try:
                if asyncio.iscoroutinefunction(fn):
                    await fn(*args, **kwargs)
                else:
                    await asyncio.to_thread(fn, *args, **kwargs)
            except Exception:
                logger.exception("background task failed")


Handler = Callable[..., Awaitable[Response]]
Middleware = Callable[[Request, Callable[[Request], Awaitable[Response]]], Awaitable[Response]]

_PARAM_RE = re.compile(r"\{(\w+)\}")


class Router:
    def __init__(self):
        self.routes: list[tuple[str, re.Pattern, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.compile(
            "^" + _PARAM_RE.sub(r"(?P<\1>[^/]+)", pattern) + "/?$"
        )
        self.routes.append((method.upper(), regex, handler))

    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self.add(method, pattern, fn)
            return fn

        return deco

    def get(self, pattern):
        return self.route("GET", pattern)

    def post(self, pattern):
        return self.route("POST", pattern)

    def patch(self, pattern):
        return self.route("PATCH", pattern)

    def delete(self, pattern):
        return self.route("DELETE", pattern)

    def match(self, method: str, path: str) -> tuple[Handler, dict[str, str]] | None:
        path_matched = False
        for m, regex, handler in self.routes:
            match = regex.match(path)
            if match:
                path_matched = True
                if m == method:
                    return handler, {
                        k: unquote(v) for k, v in match.groupdict().items()
                    }
        if path_matched:
            raise HTTPError(405, "Method not allowed")
        return None


class App:
    def __init__(self):
        self.router = Router()
        self.middleware: list[Middleware] = []
        self.on_startup: list[Callable] = []
        self.on_shutdown: list[Callable] = []
        # X-Forwarded-For is honored only when the TCP peer is one of these
        # (the server binds 0.0.0.0 directly: an untrusted client could
        # otherwise rotate the header to bypass per-IP rate limits)
        self.trusted_proxies: set[str] = set()
        self._bg_tasks: set[asyncio.Task] = set()

    def use(self, mw: Middleware) -> None:
        self.middleware.append(mw)

    async def handle(self, request: Request) -> tuple[Response, BackgroundTasks]:
        background = BackgroundTasks()

        async def endpoint(req: Request) -> Response:
            found = self.router.match(req.method, req.path)
            if found is None:
                raise HTTPError(404, "Not found")
            handler, params = found
            req.path_params = params
            result = await handler(req, background)
            return result

        chain = endpoint
        for mw in reversed(self.middleware):
            chain = _bind_mw(mw, chain)

        try:
            response = await chain(request)
        except HTTPError as e:
            response = Response.json({"detail": e.detail}, status=e.status)
        except Exception:
            logger.error("unhandled error: %s", traceback.format_exc())
            response = Response.json(
                {"detail": "Internal server error"}, status=500
            )
        return response, background

    # ---- raw socket serving ----

    async def _serve_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        client_ip = peer[0] if peer else ""
        trust_xff = client_ip in self.trusted_proxies
        try:
            while True:
                try:
                    request = await _read_request(reader, client_ip, trust_xff)
                except HTTPError as e:
                    await _write_response(
                        writer,
                        Response.json({"detail": e.detail}, status=e.status),
                        keep_alive=False,
                    )
                    break
                if request is None:
                    break
                response, background = await self.handle(request)
                keep_alive = (
                    request.headers.get("connection", "keep-alive").lower()
                    != "close"
                )
                await _write_response(writer, response, keep_alive)
                if background.tasks:
                    # run AFTER the response, off the connection loop: a
                    # multi-minute OCR extraction must not block the next
                    # request on this keep-alive connection (FastAPI
                    # BackgroundTasks semantics)
                    task = asyncio.create_task(background.run())
                    self._bg_tasks.add(task)
                    task.add_done_callback(self._bg_tasks.discard)
                if not keep_alive:
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        except Exception:
            logger.exception("client handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def serve(self, host: str, port: int) -> asyncio.AbstractServer:
        for fn in self.on_startup:
            r = fn()
            if asyncio.iscoroutine(r):
                await r
        server = await asyncio.start_server(self._serve_client, host, port)
        logger.info("listening on %s:%d", host, port)
        return server

    def run(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        async def main():
            server = await self.serve(host, port)
            async with server:
                await server.serve_forever()

        try:
            asyncio.run(main())
        except KeyboardInterrupt:
            pass


def _bind_mw(mw: Middleware, nxt):
    async def bound(req: Request) -> Response:
        return await mw(req, nxt)

    return bound


async def _read_request(
    reader: asyncio.StreamReader, client_ip: str, trust_xff: bool = False
) -> Request | None:
    try:
        request_line = await reader.readline()
    except (ValueError, asyncio.LimitOverrunError):
        raise HTTPError(431, "Request line too long")
    if not request_line:
        return None
    try:
        method, target, _version = request_line.decode("latin-1").split(None, 2)
    except ValueError:
        return None
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        if b":" in line:
            k, v = line.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > MAX_BODY:
        raise HTTPError(413, "Body too large")
    body = await reader.readexactly(length) if length else b""
    if "?" in target:
        path, qs = target.split("?", 1)
        query = {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}
    else:
        path, query = target, {}
    # client-controlled header: only meaningful behind a trusted proxy
    fwd = headers.get("x-forwarded-for") if trust_xff else None
    ip = fwd.split(",")[0].strip() if fwd else client_ip
    return Request(
        method=method.upper(),
        path=unquote(path),
        query=query,
        headers=headers,
        body=body,
        client_ip=ip,
    )


_STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


async def _write_response(
    writer: asyncio.StreamWriter, response: Response, keep_alive: bool
) -> None:
    status_text = _STATUS_TEXT.get(response.status, "Unknown")
    head = [f"HTTP/1.1 {response.status} {status_text}"]
    headers = dict(response.headers)
    headers.setdefault("Content-Type", "application/json")
    headers["Content-Length"] = str(len(response.body))
    headers["Connection"] = "keep-alive" if keep_alive else "close"
    for k, v in headers.items():
        head.append(f"{k}: {v}")
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
    writer.write(response.body)
    await writer.drain()
