"""Web frontend: a dependency-free single-page app served by the API.

Covers the reference Streamlit app's surfaces (frontend/, SURVEY.md §2.2):
upload zone with processing queue polling, review/edit page with bbox
overlay + per-field editor, analytics dashboard. Implemented as static
HTML/JS served from api/app.py at /ui — no Streamlit in the image, and a
static SPA is the deployment-friendly shape anyway.

Port of ``ocr_system_tpu/frontend``: the same files, so that ``/ui``
serves without reading the JAX package.
"""

from pathlib import Path

STATIC_DIR = Path(__file__).parent / "static"
