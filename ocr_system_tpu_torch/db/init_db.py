"""Database bootstrap (port of scripts/init_db.py: the same options and
output).

    python -m ocr_system_tpu_torch.db.init_db          create tables + seed templates
    python -m ocr_system_tpu_torch.db.init_db --check  connectivity check only
    python -m ocr_system_tpu_torch.db.init_db --reset  drop + recreate + seed

The database is ``DATABASE_PATH`` (``Settings.database_path``). Host only:
sqlite, no card.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--check", action="store_true")
    p.add_argument("--reset", action="store_true")
    args = p.parse_args(argv)

    from ocr_system_tpu_torch.core.config import get_settings
    from ocr_system_tpu_torch.db.connection import Database
    from ocr_system_tpu_torch.db.crud import Repositories, seed_templates
    from ocr_system_tpu_torch.db.migrations import migrate

    settings = get_settings()
    db = Database(settings.db_path)

    if args.check:
        ok = db.check_connection()
        print(f"database {settings.db_path}: {'ok' if ok else 'FAILED'}")
        return 0 if ok else 1

    if args.reset:
        print("dropping all tables...")
        db.drop_tables()
        db.create_tables()

    applied = migrate(db)
    if applied:
        print(f"applied migrations: {applied}")
    repos = Repositories(db)
    n = seed_templates(repos)
    print(
        f"database ready at {settings.db_path} "
        f"({n} templates seeded, {len(repos.templates.list_active())} active)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
