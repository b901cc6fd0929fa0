"""The port's HTTP application against the JAX package's: each request
scenario of tests/test_api.py and tests/test_http_server.py goes to both
apps (the fake OCR engine and the rule extractor, each app on its own
temporary storage root and database) and must give the same status codes,
headers of note and bodies, with ids, timestamps, run directories and
wall-clock times masked; a parametrised test per route group. The socket
cases run on each package's ``App.serve``. And the slice as a whole: a
committed form as a one-page scanned PDF, uploaded to the port's app with
``TorchOCREngine(device="cpu")`` and the trained weights at float32 and to
the JAX app with ``JaxOCREngine`` on the checkpoints, must give the same
fields, rows with boxes, validation and JSON and CSV exports."""

import asyncio
import hashlib
import http.client
import io
import json
import re
import threading
import urllib.error
import urllib.request
import zipfile
from pathlib import Path

import pytest
import torch
from urllib.parse import parse_qs

from test_torch_service import JAX, PORT, form_png, settings_for

import ocr_system_tpu.api.app as jax_app
import ocr_system_tpu.api.http as jax_http
import ocr_system_tpu.api.middleware as jax_mw
import ocr_system_tpu_torch.api.app as port_app
import ocr_system_tpu_torch.api.http as port_http
import ocr_system_tpu_torch.api.middleware as port_mw
from ocr_system_tpu_torch.utils import smoke
from ocr_system_tpu_torch.utils.smoke import masked

torch.set_num_threads(1)

APPS = {"jax": (JAX, jax_app, jax_http, jax_mw), "port": (PORT, port_app, port_http, port_mw)}
PNG = form_png()
_MS_CELL = re.compile(r'(\(ms\)</t></is></c><c r="B\d+"><v>)\d+(</v>)')


def body_record(headers: dict, body: bytes):
    """A response body as comparable data, by its content type."""
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("application/json"):
        return json.loads(body)
    if ctype.startswith("text/csv"):
        return body.decode("utf-8")
    if "spreadsheetml" in ctype:
        # the metadata sheet's "OCR Time (ms)" and "Extraction Time (ms)"
        # rows hold wall-clock times
        z = zipfile.ZipFile(io.BytesIO(body))
        return {n: _MS_CELL.sub(r"\1<ms>\2", z.read(n).decode("utf-8"))
                for n in sorted(z.namelist())}
    if ctype.startswith("application/pdf"):
        return body.decode("latin-1")
    return {"bytes": len(body), "sha256": hashlib.sha256(body).hexdigest()}


class Client:
    """tests/test_api.py's in-process client over ``App.handle``, on either
    package; it records every response."""

    def __init__(self, app, http_mod):
        self.app, self.http = app, http_mod
        self.log: list = []

    def request(self, method, path, body=b"", headers=None, run_bg=True):
        query = {}
        if "?" in path:
            path, qs = path.split("?", 1)
            query = {k: v[0] for k, v in parse_qs(qs, keep_blank_values=True).items()}
        req = self.http.Request(method=method, path=path, query=query, headers=headers or {},
                                body=body, client_ip="127.0.0.1")

        async def go():
            resp, bg = await self.app.handle(req)
            if run_bg:
                await bg.run()
            return resp

        resp = asyncio.run(go())
        data = body_record(resp.headers, resp.body)
        self.log.append({"request": [method, path], "status": resp.status,
                         "content_type": resp.headers.get("Content-Type"),
                         "disposition": resp.headers.get("Content-Disposition"),
                         "timed": "X-Process-Time" in resp.headers, "body": data})
        return resp.status, data

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    def post_json(self, path, data, **kw):
        return self.request("POST", path, body=json.dumps(data).encode(),
                            headers={"content-type": "application/json"}, **kw)

    def patch_json(self, path, data, **kw):
        return self.request("PATCH", path, body=json.dumps(data).encode(),
                            headers={"content-type": "application/json"}, **kw)

    def upload(self, filename, data=PNG, extra_fields=None, **kw):
        body, ctype = smoke.multipart(data, filename, extra_fields, boundary="testboundary123")
        return self.request("POST", "/api/documents/upload", body=body,
                            headers={"content-type": ctype}, **kw)


def make_client(name: str, root: Path) -> tuple[Client, object]:
    side, app_mod, http_mod, _ = APPS[name]
    s = settings_for(side, root)
    db = side.conn.Database(root / "api.db")
    orch = side.orch.ExtractionOrchestrator(
        settings=s, db=db, engine=side.pipeline.FakeOCREngine(s, text="Name: John Smith"),
        extractor=side.rules.RuleExtractor())
    ctx = app_mod.ApiContext(settings=s, db=db, orchestrator=orch)
    return Client(app_mod.create_app(ctx), http_mod), db


def both(scenario, tmp_path) -> list:
    """Run ``scenario(client)`` against each app; every response must be
    equal once masked. Returns the port's log."""
    logs = {}
    for name in APPS:
        root = tmp_path / name
        root.mkdir()
        client, db = make_client(name, root)
        try:
            scenario(client)
        finally:
            db.close()
        logs[name] = masked(client.log, paths=(str(root),))
    assert len(logs["port"]) == len(logs["jax"]) > 0
    for got, want in zip(logs["port"], logs["jax"]):
        assert got == want
    return logs["port"]


def uploaded(c, **kw) -> dict:
    status, doc = c.upload("form.png", **kw)
    assert status == 201, doc
    return doc


def extraction_id(c, doc) -> str:
    return c.get(f"/api/documents/{doc['id']}")[1]["extractions"][0]["id"]


# ---- root, health, UI ----

ROOT = {
    "root": lambda c: c.get("/"),
    "health_components": lambda c: c.get("/health"),
    "api_info": lambda c: c.get("/api"),
    "not_found": lambda c: c.get("/api/nonexistent"),
    "method_not_allowed": lambda c: c.delete("/health"),
    "timing_header": lambda c: c.get("/api/templates"),
    "ui_index_and_assets": lambda c: [c.get(p) for p in (
        "/ui", "/ui/app.js", "/ui/styles.css", "/ui/index.html", "/ui/..", "/ui/.hidden",
        "/ui/missing.js")],
}


@pytest.mark.parametrize("case", sorted(ROOT))
def test_root_routes_match_jax(case, tmp_path):
    both(ROOT[case], tmp_path)


# ---- documents ----


def _upload_and_auto_extract(c):
    doc = uploaded(c)
    c.get(f"/api/documents/{doc['id']}")


def _list_and_search(c):
    uploaded(c)
    for q in ("search=form", "search=zzz", "page=1&page_size=1", "status=completed",
              "page=0&page_size=500"):
        c.get(f"/api/documents?{q}")


def _processed_image(c, page):
    doc = uploaded(c)
    c.get(f"/api/documents/{doc['id']}/processed-image/{page}")


DOCUMENTS = {
    "upload_and_auto_extract": _upload_and_auto_extract,
    "upload_no_auto_extract": lambda c: c.get(
        f"/api/documents/{c.upload('x.png', extra_fields={'auto_extract': 'false'})[1]['id']}"),
    "upload_bad_extension": lambda c: c.upload("evil.exe", b"MZ"),
    "upload_empty_file": lambda c: c.upload("empty.png", b""),
    "upload_missing_file": lambda c: c.request(
        "POST", "/api/documents/upload", body=b"{}", headers={"content-type": "application/json"}),
    "list_and_search": _list_and_search,
    "soft_delete": lambda c: [c.delete(f"/api/documents/{d['id']}"),
                              c.get(f"/api/documents/{d['id']}")] if (d := uploaded(c)) else None,
    "processed_image_served": lambda c: _processed_image(c, 1),
    "processed_image_missing_page": lambda c: _processed_image(c, 99),
    "processed_image_bad_page": lambda c: _processed_image(c, "first"),
    "unknown_document": lambda c: [c.get("/api/documents/nope"),
                                   c.delete("/api/documents/nope")],
}


@pytest.mark.parametrize("case", sorted(DOCUMENTS))
def test_document_routes_match_jax(case, tmp_path):
    both(DOCUMENTS[case], tmp_path)


# ---- extractions ----


def _with_extraction(fn):
    def run(c):
        doc = uploaded(c)
        fn(c, doc, extraction_id(c, doc))
    return run


def _first_field(c, eid) -> str:
    return c.get(f"/api/extractions/{eid}")[1]["fields"][0]["id"]


def _field_edit_flow(c, doc, eid):
    c.patch_json(f"/api/extractions/{eid}/fields/{_first_field(c, eid)}",
                 {"field_value": "Jane Doe", "edited_by": "rev"})
    c.get(f"/api/extractions/{eid}")


def _reviewer_checkbox(c, doc, eid):
    fid = _first_field(c, eid)
    c.patch_json(f"/api/extractions/{eid}/fields/{fid}", {"is_valid": True})
    c.patch_json(f"/api/extractions/{eid}/fields/{fid}", {"is_valid": False})
    c.patch_json(f"/api/extractions/{eid}/fields/nope", {"is_valid": False})


def _finalize(c, doc, eid):
    c.post_json(f"/api/extractions/{eid}/finalize", {})
    c.post_json(f"/api/extractions/{eid}/finalize", {"confirm": True})
    c.post_json(f"/api/extractions/{eid}/finalize", {"confirm": True})


def _finalized_blocks_edits(c, doc, eid):
    fid = _first_field(c, eid)
    c.post_json(f"/api/extractions/{eid}/finalize", {"confirm": True})
    c.patch_json(f"/api/extractions/{eid}/fields/{fid}", {"field_value": "x"})
    c.post_json(f"/api/extractions/{eid}/fields", {"field_key": "X"})
    c.delete(f"/api/extractions/{eid}")


def _template_driven(c):
    status, doc = c.upload("y.png", extra_fields={"auto_extract": "false"})
    c.post_json(f"/api/extractions/{doc['id']}", {"template_name": "Application Form"})
    c.get(f"/api/extractions/{extraction_id(c, doc)}")
    c.get("/api/templates")


def _template_at_upload(c):
    status, doc = c.upload("t.png", extra_fields={"template_name": "Application Form"})
    c.get(f"/api/extractions/{extraction_id(c, doc)}")
    c.get("/api/templates")


def _add_field(c, doc, eid):
    c.post_json(f"/api/extractions/{eid}/fields",
                {"field_key": "PO Number", "field_value": "PO-77", "field_type": "number"})
    c.get(f"/api/extractions/{eid}")


def _chat(c, doc, eid):
    c.post_json(f"/api/extractions/{eid}/chat", {})
    _, out = c.post_json(f"/api/extractions/{eid}/chat", {"message": "What is the name?"})
    c.post_json(f"/api/extractions/{eid}/chat",
                {"message": "and its confidence?", "history": out["history"]})
    c.post_json(f"/api/extractions/{eid}/chat", {"message": "list all fields"})


EXTRACTIONS = {
    "get_extraction_with_layout": _with_extraction(
        lambda c, d, e: [c.get(f"/api/extractions/{e}"),
                         c.get(f"/api/extractions/{e}?include_layout=false")]),
    "current_for_document": _with_extraction(
        lambda c, d, e: [c.get(f"/api/extractions/document/{d['id']}"),
                         c.get("/api/extractions/document/nope")]),
    "status_poll": _with_extraction(lambda c, d, e: c.get(f"/api/extractions/{e}/status")),
    "unknown_extraction": lambda c: [c.get("/api/extractions/nope"),
                                     c.get("/api/extractions/nope/status"),
                                     c.post_json("/api/extractions/nope", {})],
    "reextract_conflict_while_processing": lambda c: [
        c.post_json(f"/api/extractions/{d['id']}", {}, run_bg=False),
        c.post_json(f"/api/extractions/{d['id']}", {}),
        c.get(f"/api/documents/{d['id']}")] if (d := uploaded(c)) else None,
    "field_edit_flow": _with_extraction(_field_edit_flow),
    "field_edit_missing_value": _with_extraction(
        lambda c, d, e: c.patch_json(f"/api/extractions/{e}/fields/{_first_field(c, e)}", {})),
    "field_reviewer_valid_checkbox": _with_extraction(_reviewer_checkbox),
    "validate_endpoint": _with_extraction(
        lambda c, d, e: c.post_json(f"/api/extractions/{e}/validate", {})),
    "finalize_requires_confirm": _with_extraction(_finalize),
    "finalized_blocks_edits": _with_extraction(_finalized_blocks_edits),
    "delete_extraction": _with_extraction(
        lambda c, d, e: [c.delete(f"/api/extractions/{e}"), c.get(f"/api/extractions/{e}"),
                         c.get(f"/api/documents/{d['id']}")]),
    "template_driven_extraction": _template_driven,
    "unknown_template_404": lambda c: c.post_json(
        f"/api/extractions/{uploaded(c)['id']}", {"template_name": "Nope"}),
    "template_at_upload": _template_at_upload,
    "template_at_upload_unknown_404": lambda c: c.upload(
        "t.png", extra_fields={"template_name": "Nope"}),
    "add_field": _with_extraction(_add_field),
    "add_field_requires_key": _with_extraction(
        lambda c, d, e: c.post_json(f"/api/extractions/{e}/fields", {})),
    "chat": _with_extraction(_chat),
    "malformed_json": _with_extraction(
        lambda c, d, e: c.request("POST", f"/api/extractions/{e}/validate", body=b"{nope",
                                  headers={"content-type": "application/json"})),
}


@pytest.mark.parametrize("case", sorted(EXTRACTIONS))
def test_extraction_routes_match_jax(case, tmp_path):
    both(EXTRACTIONS[case], tmp_path)


# ---- exports ----


def _create_and_download(c, doc, eid):
    _, rec = c.post_json("/api/exports", {"extraction_id": eid, "format": "json"})
    c.get(f"/api/exports/{rec['id']}")
    c.get(f"/api/exports/{rec['id']}/download")


EXPORTS = {
    "create_and_download": _with_extraction(_create_and_download),
    "quick_export_all_formats": _with_extraction(
        lambda c, d, e: [c.get(f"/api/exports/extraction/{e}/{fmt}")
                         for fmt in ("json", "csv", "excel", "pdf")]),
    "bad_format": _with_extraction(lambda c, d, e: c.get(f"/api/exports/extraction/{e}/docx")),
    "create_export_errors": _with_extraction(
        lambda c, d, e: [c.post_json("/api/exports", {}),
                         c.post_json("/api/exports", {"extraction_id": e, "format": "docx"}),
                         c.post_json("/api/exports", {"extraction_id": "nope", "format": "csv"}),
                         c.post_json("/api/exports", {"extraction_id": e, "format": "csv",
                                                      "validate_first": True}),
                         c.get("/api/exports/nope"), c.get("/api/exports/nope/download"),
                         c.get("/api/exports/extraction/nope/json")]),
}


@pytest.mark.parametrize("case", sorted(EXPORTS))
def test_export_routes_match_jax(case, tmp_path):
    both(EXPORTS[case], tmp_path)


# ---- stats and templates ----


def _after_upload(path):
    def run(c):
        uploaded(c)
        c.get(path)
    return run


STATS = {
    "dashboard": _after_upload("/api/stats/dashboard"),
    "documents_stats": _after_upload("/api/stats/documents"),
    "documents_stats_days": _after_upload("/api/stats/documents?days=0"),
    "extraction_stats": _after_upload("/api/stats/extractions"),
    "processing_stats": _after_upload("/api/stats/processing"),
    "overview": _after_upload("/api/stats/overview"),
    "templates_seeded": lambda c: c.get("/api/templates"),
    "empty_dashboard": lambda c: c.get("/api/stats/dashboard"),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_stats_routes_match_jax(case, tmp_path):
    both(STATS[case], tmp_path)


def test_devices_endpoint(tmp_path):
    """``/api/stats/devices`` answers as the JAX route does, with the
    port's own devices: ``torch.cuda``'s, none on this machine (the JAX
    route lists its CPU devices here)."""
    for name in APPS:
        (tmp_path / name).mkdir()
        client, db = make_client(name, tmp_path / name)
        status, data = client.get("/api/stats/devices")
        db.close()
        assert status == 200 and isinstance(data["devices"], list)
    assert data == {"devices": []}
    assert not torch.cuda.is_available()


# ---- regressions (tests/test_api.py TestAdviceRegressions, TestUploadTemplateAtomicity) ----


def _delete_current_promotes_previous(c):
    d = uploaded(c)
    c.post_json(f"/api/extractions/{d['id']}", {})
    _, cur = c.get(f"/api/extractions/document/{d['id']}")
    c.delete(f"/api/extractions/{cur['id']}")
    c.get(f"/api/extractions/document/{d['id']}")
    _, prev = c.get(f"/api/extractions/document/{d['id']}")
    c.delete(f"/api/extractions/{prev['id']}")
    c.get(f"/api/documents/{d['id']}")


def _unknown_template_leaves_no_orphan(c):
    c.get("/api/documents")
    c.upload("t.png", extra_fields={"template_name": "Nope"})
    c.get("/api/documents")


def _no_auto_extract_skips_usage(c):
    c.get("/api/templates")
    c.upload("t.png", extra_fields={"template_name": "Application Form", "auto_extract": "false"})
    c.get("/api/templates")


REGRESSIONS = {
    "delete_current_extraction_promotes_previous": _delete_current_promotes_previous,
    "unknown_template_leaves_no_orphan": _unknown_template_leaves_no_orphan,
    "no_auto_extract_skips_usage_increment": _no_auto_extract_skips_usage,
}


@pytest.mark.parametrize("case", sorted(REGRESSIONS))
def test_regression_routes_match_jax(case, tmp_path):
    both(REGRESSIONS[case], tmp_path)


MULTIPART = {
    "binary_payload_preserved": (
        "bnd42", b"--bnd42\r\nContent-Disposition: form-data; name=\"file\"; filename=\"x.bin\""
                 b"\r\nContent-Type: application/octet-stream\r\n\r\n\r\n\x00\x01BINARY\r\ndata"
                 b"\x0d\x0a\r\n--bnd42--\r\n"),
    "fields_and_file_mix": (
        "bnd43", b"--bnd43\r\nContent-Disposition: form-data; name=\"note\"\r\n\r\nhello\r\n"
                 b"--bnd43\r\nContent-Disposition: form-data; name=\"f\"; filename=\"a.txt\"\r\n"
                 b"\r\nabc\r\n--bnd43--\r\n"),
    "not_multipart": ("", b"{}"),
}


@pytest.mark.parametrize("case", sorted(MULTIPART))
def test_multipart_parsing_matches_jax(case):
    boundary, body = MULTIPART[case]
    ctype = f"multipart/form-data; boundary={boundary}" if boundary else "application/json"
    out = []
    for _, _, http_mod, _ in APPS.values():
        req = http_mod.Request(method="POST", path="/x", query={}, body=body,
                               headers={"content-type": ctype})
        try:
            fields, files = req.form()
            out.append((fields, {k: (f.filename, f.content_type, f.data)
                                 for k, f in files.items()}))
        except http_mod.HTTPError as e:
            out.append((e.status, e.detail))
    assert out[0] == out[1]


def test_xff_ignored_without_trusted_proxy():
    raw = b"GET /a%20b?q=1&r= HTTP/1.1\r\nHost: x\r\nX-Forwarded-For: 9.9.9.9\r\n\r\n"

    async def go(mod, trust):
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        req = await mod._read_request(reader, "10.0.0.1", trust)
        return (req.method, req.path, req.query, req.headers, req.client_ip)

    for trust in (False, True):
        got = [asyncio.run(go(APPS[n][2], trust)) for n in APPS]
        assert got[0] == got[1]
        assert got[1][-1] == ("9.9.9.9" if trust else "10.0.0.1")


def test_engine_singleton_thread_safe():
    """Concurrent first calls of ``get_engine`` build one engine (the port's
    singleton keys on the settings and the device)."""
    import time

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine import pipeline as P

    s = Settings(ocr_engine="fake", fake_ocr_text="thread safe")
    built = []
    orig = P._build_engine

    def slow_build(key, settings, device):
        time.sleep(0.05)
        e = orig(key, settings, device)
        built.append(e)
        return e

    P._build_engine = slow_build
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(P.get_engine(s, device="cpu")))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(built) == 1 and all(r is results[0] for r in results)
    finally:
        P._build_engine = orig


# ---- the socket server (tests/test_http_server.py), on each App.serve ----


class Server:
    """tests/test_http_server.py's small app on a real socket, in a
    background thread."""

    def __init__(self, http_mod, mw):
        app = http_mod.App()
        app.use(mw.rate_limit_middleware(mw.RateLimiter(
            mw.RateLimitConfig(requests_per_minute=5, exclude_paths=("/",)))))
        app.use(mw.timing_middleware)
        R = http_mod.Response

        @app.router.get("/")
        async def root(req, bg):
            return R.json({"ok": True})

        @app.router.get("/echo/{name}")
        async def echo(req, bg):
            return R.json({"name": req.path_params["name"], "q": req.query.get("q")})

        @app.router.post("/post")
        async def post(req, bg):
            return R.json({"got": req.json()}, status=201)

        @app.router.get("/boom")
        async def boom(req, bg):
            raise RuntimeError("deliberate")

        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        self.holder = {}

        def run():
            asyncio.set_event_loop(self.loop)

            async def main():
                self.holder["stop"] = asyncio.Event()
                srv = await app.serve("127.0.0.1", 0)
                self.holder["port"] = srv.sockets[0].getsockname()[1]
                started.set()
                async with srv:
                    await self.holder["stop"].wait()

            try:
                self.loop.run_until_complete(main())
            finally:
                self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(5)
        self.url = f"http://127.0.0.1:{self.holder['port']}"

    def close(self):
        self.loop.call_soon_threadsafe(self.holder["stop"].set)
        self.thread.join(5)


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _record(status, headers, body):
    keep = ("Content-Type", "Retry-After", "X-RateLimit-Remaining", "X-RateLimit-Limit",
            "Connection")
    return [status, {k: headers.get(k) for k in keep}, "X-Process-Time" in headers,
            json.loads(body) if body else None]


def _post(url):
    req = urllib.request.Request(url + "/post", data=json.dumps({"a": 1}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return _record(*get(req))


def _keep_alive(url):
    conn = http.client.HTTPConnection(url.split("//")[1], timeout=5)
    out = []
    for _ in range(3):
        conn.request("GET", "/")
        resp = conn.getresponse()
        out.append([resp.status, resp.getheader("Connection"), json.loads(resp.read())])
    conn.close()
    return out


def _oversized(url):
    conn = http.client.HTTPConnection(url.split("//")[1], timeout=5)
    conn.putrequest("POST", "/post")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(100 * 1024 * 1024))
    conn.endheaders()
    resp = conn.getresponse()
    out = [resp.status, json.loads(resp.read())]
    conn.close()
    return out


def _concurrent(url):
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return sorted(ex.map(lambda _: get(url + "/")[0], range(16)))


SOCKET = {
    "basic_get": lambda u: _record(*get(u + "/")),
    "path_params_and_query": lambda u: _record(*get(u + "/echo/world?q=1")),
    "post_json": _post,
    "404_detail_shape": lambda u: _record(*get(u + "/nope")),
    "unhandled_error_500": lambda u: _record(*get(u + "/boom")),
    "keep_alive_reuses_connection": _keep_alive,
    "rate_limit_429": lambda u: [_record(*get(u + "/echo/x")) for _ in range(7)],
    "rate_limit_excludes_root": lambda u: [get(u + "/")[0] for _ in range(10)],
    "concurrent_requests": _concurrent,
    "oversized_body_413": _oversized,
}


@pytest.mark.parametrize("case", sorted(SOCKET))
def test_socket_server_matches_jax(case):
    out = {}
    for name, (_, _, http_mod, mw) in APPS.items():
        server = Server(http_mod, mw)
        try:
            out[name] = SOCKET[case](server.url)
        finally:
            server.close()
    assert out["port"] == out["jax"] and out["port"]


# ---- the slice as a whole: a scanned PDF through both apps ----


@pytest.fixture(scope="module")
def one_page_pdf() -> bytes:
    forms, _ = smoke.smoke_forms()
    return smoke.scanned_pdf([forms[4][..., 0]])


def test_one_page_upload_matches_jax_app(one_page_pdf, tmp_path):
    """Committed form 5 as a one-page scanned PDF, trained weights, float32:
    upload, background extraction and the current extraction and its
    exports through the port's app on ``TorchOCREngine(device="cpu")``,
    against the JAX app on ``JaxOCREngine``. Fields in order with their
    confidences, the rows with their key and value boxes (within 0.5 px),
    the validation and the JSON and CSV exports must be equal."""
    from export_torch_weights import SMOKE_SETTINGS, jax_service_record, rounded_bf16

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.pipeline import _build_engine as jax_build_engine
    from ocr_system_tpu.extract.layout_model import LayoutModelExtractor as JaxExtractor
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.db.connection import Database
    from ocr_system_tpu_torch.extract.layout_model import get_extractor
    from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator

    repo = Path(__file__).resolve().parents[1]
    common = dict(**SMOKE_SETTINGS, compute_dtype="float32", det_image_buckets=(960,),
                  pdf_raster_dpi=smoke.SERVICE_DPI, warmup_on_start=False)
    js = JaxSettings(**common, det_checkpoint=str(repo / "checkpoints/det"),
                     rec_checkpoint=str(repo / "checkpoints/rec_latin"),
                     rec_checkpoint_devanagari=str(repo / "checkpoints/rec_devanagari"),
                     extract_checkpoint=str(repo / "checkpoints/extract"))
    want = jax_service_record(js, jax_build_engine("hybrid", js),
                              JaxExtractor(js, params=rounded_bf16(JaxExtractor(js).variables)),
                              one_page_pdf, "form5.pdf", tmp_path / "jax")

    s = Settings(**common, **smoke.TRAINED, storage_root=str(tmp_path / "port"),
                 database_path=str(tmp_path / "port" / "app.db"))
    engine = smoke.build_engine("cpu", **common)
    db = Database(s.db_path)
    try:
        orch = ExtractionOrchestrator(s, engine=engine, extractor=get_extractor(s, device="cpu"),
                                      db=db)
        app = port_app.create_app(port_app.ApiContext(settings=s, db=db, orchestrator=orch))
        got = smoke.app_upload(app, port_http.Request, one_page_pdf, "form5.pdf")
    finally:
        db.close()
    cmp = smoke.compare_service(want, got, 0.0, 0.5)
    assert cmp["fields_equal"] and cmp["rows_equal"], cmp
    assert cmp["validation_equal"] and cmp["json_equal"] and cmp["csv_equal"], cmp
    assert cmp["markdown_equal"] and cmp["form_type_equal"], cmp
    assert got["layout_boxes"] == want["layout_boxes"] and cmp["fields"] > 5
    assert got["model_name"] == want["model_name"] == "layout_model"


def test_service_record_is_current():
    """assets/service_expected.json (export_torch_weights.py) still says
    what the other committed records say of the same pages: per compute
    dtype the JAX engine's markdown and layout of the Latin wave
    (smoke_forms_expected.json) and the JAX orchestrator's fields, rows,
    confidences and validation on it (extract_expected.json). When the
    checkpoints, the forms or the pipeline change, those records are
    rewritten and this one goes stale with them."""
    from ocr_system_tpu_torch.engine.pipeline import combine_markdown

    _, record = smoke.service_upload()
    _, pages = smoke.smoke_forms()
    e2e = smoke.extract_expected()["e2e"]
    assert record["pdf_raster_dpi"] == smoke.SERVICE_DPI
    assert record["settings"] == pages["settings"]
    for dt in ("float32", "bfloat16"):
        got, wave = record[dt], pages["pages"][dt]
        assert got["markdown"] == combine_markdown([p["markdown"] for p in wave])
        assert got["layout_boxes"] == sum(len(p[t]) for p in wave for t in smoke.LAYOUT_TYPES)
        assert [[f["key"], f["value"], f["type"], f["confidence"]] for f in got["fields"]] == \
            [[r["field_key"], r["field_value"], r["field_type"], r["confidence"]]
             for r in e2e[dt]["rows"]]
        assert [(f["key_bbox"], f["value_bbox"], f["page"]) for f in got["fields"]] == \
            [(r["key_bbox"], r["value_bbox"], r["page_number"]) for r in e2e[dt]["rows"]]
        report = e2e[dt]["report"]
        assert (got["validation"]["valid"], got["validation"]["invalid"],
                got["validation"]["needs_review"]) == (
            report["valid_fields"], report["invalid_fields"], report["needs_review"])
        assert got["form_type"] == e2e[dt]["result"]["form_type"]
        assert len(got["csv_export"]) == len(got["fields"]) + 1


def test_main_builds_its_engine_on_the_card(tmp_path, monkeypatch):
    """``python -m ocr_system_tpu_torch.api.app`` builds the serving
    engine on ``cuda`` (``core/dtypes.resolve_device``): without a card it
    raises instead of serving on the CPU."""
    from ocr_system_tpu_torch.core.config import reset_settings_cache
    from ocr_system_tpu_torch.db import connection

    monkeypatch.chdir(tmp_path)
    reset_settings_cache()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_app.main()
    finally:
        connection.set_database(None)
        reset_settings_cache()


# ---- the extraction chat (tests/test_chat.py), in both packages ----

CHAT_FIELDS = [
    {"field_key": "Invoice Number", "field_value": "INV-2024-001", "confidence": 0.95,
     "field_type": "number", "is_valid": True, "page_number": 1,
     "value_bbox": {"polygon": [140, 96, 260, 96, 260, 120, 140, 120], "page": 1}},
    {"field_key": "Total Amount", "field_value": "$1,234.56", "confidence": 0.91,
     "field_type": "currency", "is_valid": True, "page_number": 1},
    {"field_key": "Customer", "field_value": "John Smith", "confidence": 0.41,
     "field_type": "name", "is_edited": True, "original_value": "Jhn Smth", "page_number": 2,
     "value_bbox": {"polygon": [80, 40, 200, 40, 200, 60, 80, 60], "page": 2}},
    {"field_key": "Due Date", "field_value": "2024-01-15", "confidence": 0.88,
     "field_type": "date", "page_number": 2},
    {"field_key": "Date", "field_value": "2024-01-01", "confidence": 0.82, "field_type": "date",
     "page_number": 1},
    {"field_key": "Date", "field_value": "2024-01-02", "confidence": 0.64, "field_type": "date",
     "is_valid": False, "validation_message": "ambiguous day/month", "page_number": 1},
]
CHAT_LAYOUT = [
    {"type": "line", "content": "PO Number:", "confidence": 0.93,
     "polygon": [100, 300, 190, 300, 190, 320, 100, 320], "page_number": 1},
    {"type": "line", "content": "7712", "confidence": 0.9,
     "polygon": [205, 300, 250, 300, 250, 320, 205, 320], "page_number": 1},
    {"type": "line", "content": "Reference: AB-99", "confidence": 0.9,
     "polygon": [100, 350, 300, 350, 300, 370, 100, 370], "page_number": 1},
]
CHAT_OCR = "INVOICE\nInvoice Number INV-2024-001\nTotal Amount $1,234.56\nCustomer Jhn Smth"
CONVERSATIONS = {
    "lookups": ["what is the invoice number?", "total?", "list fields",
                "which fields are uncertain?", "find Smth", "find zebra unicorns"],
    "follow_ups": ["what is the invoice number?", "and its confidence?", "what is the customer?",
                   "what page is it on?", "where is it?", "was it edited?"],
    "aggregates": ["which fields are low confidence on page 2", "which fields are below 90%?",
                   "how many fields are there?", "how many fields on page 1?",
                   "what is the average confidence?"],
    "reconcile": ["the dates conflict - which is right?", "reconcile the customer",
                  "what about the PO number?", "find the reference", "", "???"],
}


@pytest.mark.parametrize("case", sorted(CONVERSATIONS))
def test_chat_matches_jax(case):
    from ocr_system_tpu.extract.chat import ExtractionChat as JaxChat
    from ocr_system_tpu_torch.extract.chat import ExtractionChat

    out = []
    for cls in (JaxChat, ExtractionChat):
        chat = cls(fields=[dict(f) for f in CHAT_FIELDS], ocr_text=CHAT_OCR,
                   layout_boxes=[dict(b) for b in CHAT_LAYOUT])
        replies = [chat.send(m) for m in CONVERSATIONS[case]]
        out.append([replies, [(t.role, t.text, t.fields) for t in chat.history]])
    assert out[0] == out[1]
    assert all(r["reply"] for r in out[1][0])
