"""The port's diag entry points (``training/diag_forms``, ``diag_hindi``,
``diag_extract_pipeline``, ``diag_one_doc``) beside the JAX scripts, at one
page or document each with the trained weights at float32: the printed
report is equal. As in tests/test_torch_scripts.py, the JAX script runs in
a subprocess with ``JAX_PLATFORMS=cpu`` and the port's in this process on
the CPU, both packages' ``Settings`` defaulting to float32."""

import numpy as np
import pytest
import torch
from test_torch_scripts import port_float32, run_jax, run_port  # noqa: F401

torch.set_num_threads(1)

CASES = {
    "diag_forms": ("--pages", "1"),
    "diag_hindi": ("--pages", "1"),
    "diag_extract_pipeline": ("--docs", "1"),
    "diag_one_doc": ("--doc", "0"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_diag_matches_jax(name, tmp_path, capsys, port_float32):  # noqa: F811
    import importlib

    args = list(CASES[name])
    if name == "diag_one_doc":
        args += ["--save-png", "{dir}/page.png"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax = run_jax(name, *[a.replace("{dir}", str(jax_dir)) for a in args])
    assert jax.returncode == 0, jax.stderr[-3000:]
    main = importlib.import_module(f"ocr_system_tpu_torch.training.{name}").main
    port = run_port(main, [a.replace("{dir}", str(port_dir)) for a in args] + ["--device", "cpu"],
                    capsys)
    assert port == jax.stdout
    assert len(port.splitlines()) >= 3
    if name == "diag_one_doc":
        from PIL import Image

        got = np.asarray(Image.open(port_dir / "page.png"))
        want = np.asarray(Image.open(jax_dir / "page.png"))
        assert got.shape == want.shape == (960, 960, 3) and np.array_equal(got, want)
