"""The port's entry points for the JAX package's scripts, each run beside
its JAX script on the same inputs: ``db/init_db`` and ``db/db_admin``
(equal tables, seeds and reports on temporary sqlite files, a file written
by either package read by the other), ``utils/debug_engine`` (the fake
engine's report on a committed form's PNG, times masked), ``utils/demo``
(the classical engine's OCR and fields) and ``training/compare_extractors``
(the printed metrics at one form). The diag scripts:
tests/test_torch_scripts_diag.py.

The JAX script runs in a subprocess with ``JAX_PLATFORMS=cpu``; the port's
runs in this process on the CPU. Models run at float32 in both: the
scripts build their ``Settings`` themselves, so both packages' ``Settings``
default to float32 for the run (``JAX_FLOAT32``, ``port_float32``)."""

import json
import os
import re
import shutil
import sqlite3
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ocr_system_tpu_torch.core import config as port_config
from ocr_system_tpu_torch.utils import smoke

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# runs a JAX script with the JAX package's Settings defaulting to float32
JAX_FLOAT32 = r'''
import runpy, sys
from ocr_system_tpu.core import config
init = config.Settings.__init__
def float32(self, **kw):
    kw.setdefault("compute_dtype", "float32")
    init(self, **kw)
config.Settings.__init__ = float32
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
'''


def run_jax(script: str, *args: str, env: dict | None = None) -> subprocess.CompletedProcess:
    """The JAX script as a user runs it on the CPU: one device (the tests'
    8-device ``XLA_FLAGS`` dropped)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), **(env or {})}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", JAX_FLOAT32, f"scripts/{script}.py", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


def run_port_cli(module: str, *args: str, env: dict | None = None) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO), **(env or {})}
    return subprocess.run([sys.executable, "-m", f"ocr_system_tpu_torch.{module}", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


@pytest.fixture
def port_float32(monkeypatch):
    init = port_config.Settings.__init__

    def float32(self, **kw):
        kw.setdefault("compute_dtype", "float32")
        init(self, **kw)

    monkeypatch.setattr(port_config.Settings, "__init__", float32)


def run_port(main, argv: list[str], capsys) -> str:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


# ---------------- the database entry points ----------------

def _env(db: Path) -> dict:
    return {"DATABASE_PATH": str(db), "STORAGE_ROOT": str(db.parent / "storage")}


def run_port_db(name: str, *args: str, env: dict) -> tuple[int, str]:
    """A database entry point's ``main`` in this process under ``env``:
    (exit code, standard output)."""
    import contextlib
    import importlib
    import io

    from ocr_system_tpu_torch.core.config import reset_settings_cache

    main = importlib.import_module(f"ocr_system_tpu_torch.db.{name}").main
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_settings_cache()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            try:
                code = main(list(args)) or 0
            except SystemExit as e:  # a message exits 1, as the interpreter does
                code = e.code if isinstance(e.code, int) else 1
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_settings_cache()
    return code, out.getvalue()


def _both(tmp_path: Path, name: str, *args: str, db: Path | None = None):
    """The JAX script and the port's entry point on copies of ``db`` (or
    each on a new file); their exit codes and outputs with the database's
    directory masked, and the files."""
    outs = []
    for pkg in ("jax", "port"):
        path = tmp_path / pkg / "x.db"
        path.parent.mkdir(exist_ok=True)
        if db is not None:
            shutil.copy(db, path)
        argv = [a.replace("{dir}", str(path.parent)) for a in args]
        if pkg == "jax":
            proc = run_jax(name, *argv, env=_env(path))
            code, out = proc.returncode, proc.stdout
        else:
            code, out = run_port_db(name, *argv, env=_env(path))
        outs.append((code, out.replace(str(path.parent), "{dir}"), path))
    return outs


def _rows(db: Path) -> dict:
    """Every table's rows (template rows without their ids and times)."""
    con = sqlite3.connect(db)
    out = {}
    for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type='table' "
                               "AND name NOT LIKE 'sqlite_%' ORDER BY name"):
        cols = [d[1] for d in con.execute(f"PRAGMA table_info({name})")]
        keep = [c for c in cols if c not in ("id", "created_at", "updated_at")]
        out[name] = sorted(map(str, con.execute(f"SELECT {', '.join(keep)} FROM {name}")))
    con.close()
    return out


@pytest.mark.parametrize("args", [(), ("--check",), ("--reset",)], ids=["seed", "check", "reset"])
def test_init_db_matches_jax(tmp_path, args):
    (jrc, jout, jdb), (prc, pout, pdb) = _both(tmp_path, "init_db", *args)
    assert jrc == prc == 0 and jout == pout
    if args != ("--check",):
        assert "templates seeded" in pout
        assert _rows(jdb) == _rows(pdb) and _rows(pdb)["form_templates"]


@pytest.fixture(scope="module")
def seeded(tmp_path_factory) -> Path:
    """A database the JAX script seeded, with one soft-deleted document
    holding an extraction and a field, and one live document (the port's
    repositories write them)."""
    from ocr_system_tpu_torch.db.connection import Database
    from ocr_system_tpu_torch.db.crud import Repositories

    db = tmp_path_factory.mktemp("seeded") / "seed.db"
    assert run_jax("init_db", env=_env(db)).returncode == 0
    repos = Repositories(Database(db))
    for name, deleted in (("kept.pdf", False), ("gone.pdf", True)):
        doc = repos.documents.create(filename=name, original_filename=name,
                                     file_path=f"/x/{name}", file_size=10, file_type="pdf")
        ext = repos.extractions.create_new_version(doc["id"])
        repos.fields.bulk_create(ext["id"], [{"field_key": "Name", "field_value": "Ada",
                                               "confidence": 0.9}])
        if deleted:
            repos.documents.soft_delete(doc["id"])
    repos.db.close()
    return db


ADMIN = {
    "tables": ("tables",), "check": ("check",), "vacuum": ("vacuum",),
    "backup": ("backup", "{dir}/bk.db"), "purge": ("purge-deleted",),
    "sql": ("sql", "SELECT filename, is_deleted FROM documents ORDER BY filename"),
    "sql_pragma": ("sql", "PRAGMA user_version"),
    "sql_refused": ("sql", "DELETE FROM documents"),
}


@pytest.mark.parametrize("name", sorted(ADMIN))
def test_db_admin_matches_jax(tmp_path, seeded, name):
    (jrc, jout, jdb), (prc, pout, pdb) = _both(tmp_path, "db_admin", *ADMIN[name], db=seeded)
    assert jrc == prc and jout == pout
    assert (jrc != 0) == (name == "sql_refused")
    assert _rows(jdb) == _rows(pdb)
    if name == "backup":
        assert _rows(jdb.parent / "bk.db") == _rows(pdb.parent / "bk.db") == _rows(seeded)
    if name == "purge":
        assert "purged 1 soft-deleted" in pout and len(_rows(pdb)["documents"]) == 1


def test_db_admin_inspect_matches_jax(tmp_path, seeded):
    con = sqlite3.connect(seeded)
    (doc_id,) = con.execute("SELECT id FROM documents WHERE filename = 'kept.pdf'").fetchone()
    con.close()
    (jrc, jout, _), (prc, pout, _) = _both(tmp_path, "db_admin", "inspect", doc_id, db=seeded)
    assert jrc == prc == 0 and jout == pout and "'Name': 'Ada'" in pout


def test_database_files_cross_read(tmp_path):
    """A file written by either package's init_db is read by the other's
    db_admin: the JAX script on the port's file reports what the port's
    entry point reports on the JAX script's file (the same tables, row
    counts, file size and integrity); the port's ``python -m`` route checks
    the JAX file."""
    (_, _, jdb), (_, _, pdb) = _both(tmp_path, "init_db")
    for cmd in ("tables", "check"):
        jax = run_jax("db_admin", cmd, env=_env(pdb))
        assert jax.returncode == 0 and jax.stdout
        assert (0, jax.stdout) == run_port_db("db_admin", cmd, env=_env(jdb))
    proc = run_port_cli("db.init_db", "--check", env=_env(jdb))
    assert proc.returncode == 0 and proc.stdout == f"database {jdb}: ok\n"


# ---------------- the engine entry points ----------------

def _masked(report: str) -> dict:
    out = json.loads(report)
    out.pop("processing_time_ms")
    return out


def test_debug_engine_matches_jax(tmp_path, capsys, monkeypatch):
    from PIL import Image

    from ocr_system_tpu_torch.core.config import reset_settings_cache
    from ocr_system_tpu_torch.utils import debug_engine

    png = tmp_path / "form1.png"
    Image.fromarray(smoke.smoke_forms()[0][1]).save(png)
    jax = run_jax("debug_engine", str(png), "--engine", "fake", env=_env(tmp_path / "d.db"))
    assert jax.returncode == 0, jax.stderr[-2000:]
    for key, value in _env(tmp_path / "d.db").items():
        monkeypatch.setenv(key, value)
    reset_settings_cache()
    try:
        port = run_port(debug_engine.main, [str(png), "--engine", "fake", "--device", "cpu"],
                        capsys)
    finally:
        reset_settings_cache()
    got, want = _masked(port), _masked(jax.stdout)
    assert got == want and got["success"] and got["combined_layout_boxes_count"] > 0
    out = tmp_path / "report.json"
    run_port(debug_engine.main, [str(png), "--engine", "fake", "--out", str(out)], capsys)
    assert _masked(out.read_text()) == want


def test_demo_matches_jax(capsys, port_float32):
    from ocr_system_tpu_torch.utils import demo

    jax = run_jax("demo")
    assert jax.returncode == 0, jax.stderr[-2000:]
    port = run_port(demo.main, ["--device", "cpu"], capsys)

    def masked(text):
        return re.sub(r"\(\d+ ms,", "(ms,", text)

    assert masked(port) == masked(jax.stdout)
    assert "Invoice Number: '2024-0042'" in port


def test_compare_extractors_matches_jax(capsys, port_float32):
    from ocr_system_tpu_torch.training import compare_extractors

    jax = run_jax("compare_extractors", "--forms", "1", "--a", "checkpoints/extract",
                  "--b", "checkpoints/extract")
    assert jax.returncode == 0, jax.stderr[-2000:]
    npz = str(REPO / "ocr_system_tpu_torch" / "weights" / "extract.npz")
    port = run_port(compare_extractors.main,
                    ["--forms", "1", "--a", npz, "--b", npz, "--device", "cpu"], capsys)

    def fields(text):
        return [line.split(" ", 2)[::2] if line[:2] in ("A ", "B ") else line.split(" ", 1)
                for line in text.splitlines()]

    assert fields(port) == fields(jax.stdout)
    assert port.splitlines()[-1].startswith("VERDICT ")


def test_entry_points_refuse_without_a_card(capsys):
    """No ``--device``: the engine entry points build on the card, and
    there is none here."""
    from ocr_system_tpu_torch.utils import demo

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main([])
