"""Schema migrations (reference: backend/alembic/ with 2 revisions).

Port of ``ocr_system_tpu/db/migrations.py``: the same code, on the port's modules.

sqlite-native mechanism: a `schema_version` pragma row; each migration is a
(version, sql | callable) pair applied in order inside one transaction.
The base DDL (schema.py) always creates the CURRENT schema, so migrations
only matter for databases created by older builds — mirroring how the
reference's alembic revisions (001_add_bbox_columns, 002_add_key_value_bbox)
upgraded pre-bbox databases.
"""

from __future__ import annotations

from ocr_system_tpu_torch.db.connection import Database

# (version, description, statements)
MIGRATIONS: list[tuple[int, str, list[str]]] = [
    # v1 is the base schema (created by schema.DDL)
    # future example:
    # (2, "add documents.source_url", ["ALTER TABLE documents ADD COLUMN source_url TEXT"]),
]

CURRENT_VERSION = 1 + (MIGRATIONS[-1][0] - 1 if MIGRATIONS else 0)


def get_version(db: Database) -> int:
    with db.session() as conn:
        return conn.execute("PRAGMA user_version").fetchone()[0]


def set_version(db: Database, v: int) -> None:
    with db.session() as conn:
        conn.execute(f"PRAGMA user_version = {int(v)}")


def migrate(db: Database) -> list[int]:
    """Apply pending migrations; returns list of applied versions."""
    version = get_version(db)
    if version == 0:
        # fresh database: base DDL already matches current schema
        set_version(db, CURRENT_VERSION)
        return []
    applied = []
    for v, _desc, statements in MIGRATIONS:
        if v <= version:
            continue
        with db.session() as conn:
            for stmt in statements:
                conn.execute(stmt)
        set_version(db, v)
        applied.append(v)
    return applied
