"""io/native.py builds native/ from source: `make -C native` under a lock,
and get_lib() loads exactly that build."""

import os

from graphtyper_tpu.io import native


def test_build_is_idempotent_and_loads_checkout_build():
    assert native.build() is True  # up to date: make has nothing to do
    lib = native.get_lib()
    assert lib is not None
    assert os.path.samefile(lib._name, native.LIB_PATH)
    assert native.LIB_PATH == os.path.join(native.NATIVE_DIR, "libgt_native.so")


def test_build_without_sources_reports_false(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    assert native.build() is False
