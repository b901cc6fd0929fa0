"""Database admin / inspection (port of scripts/db_admin.py: the same
commands and output).

The sqlite-backed single-node deployment's ops story: inspect, verify,
compact, back up, and purge, without an external admin UI. The database is
``DATABASE_PATH`` (``Settings.database_path``). Host only: sqlite, no card.

Usage:
  python -m ocr_system_tpu_torch.db.db_admin tables              # row counts per table
  python -m ocr_system_tpu_torch.db.db_admin inspect DOC_ID      # one document's tree
  python -m ocr_system_tpu_torch.db.db_admin check               # integrity + FK audit
  python -m ocr_system_tpu_torch.db.db_admin vacuum              # compact + analyze
  python -m ocr_system_tpu_torch.db.db_admin backup OUT.db       # consistent online copy
  python -m ocr_system_tpu_torch.db.db_admin purge-deleted       # hard-delete soft-deleted
  python -m ocr_system_tpu_torch.db.db_admin sql "SELECT ..."    # read-only query (rows)
"""

from __future__ import annotations

import argparse
import json


def _db():
    from ocr_system_tpu_torch.core.config import get_settings
    from ocr_system_tpu_torch.db.connection import Database

    return Database(get_settings().database_path)


def cmd_tables(args) -> None:
    db = _db()
    with db.session() as conn:
        names = [
            r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "AND name NOT LIKE 'sqlite_%' ORDER BY name"
            )
        ]
        for name in names:
            n = conn.execute(f"SELECT COUNT(*) FROM {name}").fetchone()[0]
            print(f"{name:24} {n}")
        size = conn.execute(
            "SELECT page_count * page_size FROM pragma_page_count, "
            "pragma_page_size"
        ).fetchone()[0]
        print(f"{'(file bytes)':24} {size}")


def cmd_inspect(args) -> None:
    db = _db()
    with db.session() as conn:
        conn.row_factory = None
        doc = conn.execute(
            "SELECT * FROM documents WHERE id = ?", (args.id,)
        ).fetchone()
        if doc is None:
            raise SystemExit(f"no document {args.id}")
        cols = [d[0] for d in conn.execute(
            "SELECT * FROM documents LIMIT 0"
        ).description]
        print(json.dumps(dict(zip(cols, doc)), indent=2, default=str))
        for ext in conn.execute(
            "SELECT id, status, version, is_current, total_fields, "
            "avg_confidence FROM extractions WHERE document_id = ? "
            "ORDER BY version", (args.id,)
        ):
            print(f"  extraction {ext[0]} status={ext[1]} v{ext[2]} "
                  f"current={ext[3]} fields={ext[4]} conf={ext[5]}")
            for f in conn.execute(
                "SELECT field_key, field_value, confidence, is_valid "
                "FROM extracted_fields WHERE extraction_id = ? "
                "ORDER BY sort_order LIMIT 50", (ext[0],)
            ):
                print(f"    {f[0]!r}: {f[1]!r} (conf {f[2]}, valid {f[3]})")


def cmd_check(args) -> None:
    db = _db()
    with db.session() as conn:
        ok = conn.execute("PRAGMA integrity_check").fetchone()[0]
        print(f"integrity_check: {ok}")
        fk = conn.execute("PRAGMA foreign_key_check").fetchall()
        print(f"foreign_key_check: {len(fk)} violations")
        for row in fk[:20]:
            print(f"  {row}")
        # referential audit the PRAGMA can't see (app-level invariants)
        orphans = conn.execute(
            "SELECT COUNT(*) FROM extracted_fields f LEFT JOIN extractions "
            "e ON f.extraction_id = e.id WHERE e.id IS NULL"
        ).fetchone()[0]
        multi = conn.execute(
            "SELECT document_id, COUNT(*) c FROM extractions WHERE "
            "is_current = 1 GROUP BY document_id HAVING c > 1"
        ).fetchall()
        print(f"orphan fields: {orphans}")
        print(f"documents with >1 current extraction: {len(multi)}")
        if orphans or multi or (ok != "ok") or fk:
            raise SystemExit(1)


def cmd_vacuum(args) -> None:
    db = _db()
    with db.session() as conn:
        before = conn.execute(
            "SELECT page_count * page_size FROM pragma_page_count, "
            "pragma_page_size"
        ).fetchone()[0]
    # VACUUM cannot run inside a transaction scope
    import sqlite3

    from ocr_system_tpu_torch.core.config import get_settings

    raw = sqlite3.connect(get_settings().database_path)
    raw.execute("VACUUM")
    raw.execute("ANALYZE")
    raw.close()
    with db.session() as conn:
        after = conn.execute(
            "SELECT page_count * page_size FROM pragma_page_count, "
            "pragma_page_size"
        ).fetchone()[0]
    print(f"vacuum: {before} -> {after} bytes")


def cmd_backup(args) -> None:
    import sqlite3

    from ocr_system_tpu_torch.core.config import get_settings

    src = sqlite3.connect(get_settings().database_path)
    dst = sqlite3.connect(args.out)
    with dst:
        src.backup(dst)  # online, WAL-consistent snapshot
    dst.close()
    src.close()
    print(f"backed up to {args.out}")


def cmd_purge(args) -> None:
    db = _db()
    with db.session() as conn:
        docs = [
            r[0] for r in conn.execute(
                "SELECT id FROM documents WHERE is_deleted = 1"
            )
        ]
        for did in docs:
            conn.execute(
                "DELETE FROM field_edits WHERE extraction_id IN "
                "(SELECT id FROM extractions WHERE document_id = ?)", (did,)
            )
            conn.execute(
                "DELETE FROM extracted_fields WHERE extraction_id IN "
                "(SELECT id FROM extractions WHERE document_id = ?)", (did,)
            )
            conn.execute(
                "DELETE FROM extractions WHERE document_id = ?", (did,)
            )
            conn.execute(
                "DELETE FROM processing_logs WHERE document_id = ?", (did,)
            )
            conn.execute("DELETE FROM documents WHERE id = ?", (did,))
    print(f"purged {len(docs)} soft-deleted document(s)")


def cmd_sql(args) -> None:
    lowered = args.query.strip().lower()
    if not lowered.startswith("select") and not lowered.startswith("pragma"):
        raise SystemExit("read-only: SELECT/PRAGMA only")
    db = _db()
    with db.session() as conn:
        cur = conn.execute(args.query)
        cols = [d[0] for d in cur.description] if cur.description else []
        print("\t".join(cols))
        for row in cur.fetchmany(200):
            print("\t".join(str(v) for v in row))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("tables").set_defaults(fn=cmd_tables)
    pi = sub.add_parser("inspect")
    pi.add_argument("id")
    pi.set_defaults(fn=cmd_inspect)
    sub.add_parser("check").set_defaults(fn=cmd_check)
    sub.add_parser("vacuum").set_defaults(fn=cmd_vacuum)
    pb = sub.add_parser("backup")
    pb.add_argument("out")
    pb.set_defaults(fn=cmd_backup)
    sub.add_parser("purge-deleted").set_defaults(fn=cmd_purge)
    ps = sub.add_parser("sql")
    ps.add_argument("query")
    ps.set_defaults(fn=cmd_sql)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
