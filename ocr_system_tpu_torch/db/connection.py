"""SQLite connection management.

Port of ``ocr_system_tpu/db/connection.py``: the same code, on the port's modules.

Plays the role of the reference's dual-engine module
(backend/database/connection.py:42-148): thread-local connections (sqlite3
objects are not thread-safe), context-managed transactions with
commit/rollback, create/drop helpers, and a dependency-style accessor for
the API layer. WAL mode allows concurrent readers while the single writer
(the extraction orchestrator) proceeds.
"""

from __future__ import annotations

import contextlib
import sqlite3
import threading
from datetime import datetime, timezone
from pathlib import Path
from typing import Iterator
from uuid import uuid4

from ocr_system_tpu_torch.core.config import get_settings
from ocr_system_tpu_torch.db.schema import DDL


def utcnow() -> str:
    return datetime.now(timezone.utc).isoformat()


def new_id() -> str:
    return str(uuid4())


class Database:
    def __init__(self, path: str | Path | None = None):
        self.path = str(path if path is not None else get_settings().db_path)
        self._local = threading.local()
        self._init_lock = threading.Lock()
        self._initialized = False
        self.create_tables()

    def _connect(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA foreign_keys=ON")
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
        return conn

    @contextlib.contextmanager
    def session(self) -> Iterator[sqlite3.Connection]:
        """Transaction scope with commit/rollback (reference get_db,
        connection.py:60-78)."""
        conn = self._connect()
        try:
            yield conn
            conn.commit()
        except Exception:
            conn.rollback()
            raise

    def create_tables(self) -> None:
        with self._init_lock:
            conn = self._connect()
            conn.executescript(DDL)
            conn.commit()
            self._initialized = True

    def drop_tables(self) -> None:
        conn = self._connect()
        rows = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"
        ).fetchall()
        for r in rows:
            conn.execute(f"DROP TABLE IF EXISTS {r['name']}")
        conn.commit()

    def check_connection(self) -> bool:
        """Health-check probe (reference scripts/init_db.py:42-68)."""
        try:
            self._connect().execute("SELECT 1").fetchone()
            return True
        except Exception:
            return False

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


_db_singleton: Database | None = None
_db_lock = threading.Lock()


def get_database() -> Database:
    global _db_singleton
    if _db_singleton is None:
        with _db_lock:
            if _db_singleton is None:
                _db_singleton = Database()
    return _db_singleton


def set_database(db: Database | None) -> None:
    """Test/embedding hook to swap the process database."""
    global _db_singleton
    _db_singleton = db
