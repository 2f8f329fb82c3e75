"""PyTorch port: the port's JNI library and the telemetry entries it
reaches.  The library exports the JAX package's binding symbols, one for
one, so the same Java classes load either library; it and its builder
name no module of the JAX package; its builder raises, with g++'s
message, rather than fall back.  After initialize() with
SPARK_RAPIDS_TPU_PLATFORM=cpu the port's telemetry entries answer for
the CPU, as the JAX package's do."""

import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from spark_rapids_tpu.shim import jni_entry as JJ
from spark_rapids_tpu_torch.shim import jni_entry as J
from spark_rapids_tpu_torch.shim import jni_native
from spark_rapids_tpu_torch.utils import platform

REPO = Path(__file__).resolve().parents[1]
JAX_BINDING = REPO / "native" / "jni" / "spark_rapids_tpu_jni.cpp"
PORT_BINDING = jni_native.JNI_SRC / jni_native.SOURCE


def binding_symbols(source: str):
    """The Java_com_nvidia_spark_rapids_jni_* names a binding source
    defines: through its JNI_FN(class, method) macro, or spelled out."""
    prefix = "Java_com_nvidia_spark_rapids_jni_"
    names = {prefix + f"{c}_{m}" for c, m in
             re.findall(r"JNI_FN\((\w+),\s*(\w+)\)", source)
             if (c, m) != ("cls", "name")}
    return names | set(re.findall(prefix + r"\w+", source))


@pytest.fixture(scope="module")
def library():
    try:
        jni_native.find_jdk()
    except jni_native.JniBuildError as e:
        pytest.skip(str(e))
    return jni_native.build_jni_library()


def test_library_exports_the_jax_bindings_symbols(library):
    nm = subprocess.run(["nm", "-D", "--defined-only", str(library)],
                        capture_output=True, text=True, check=True)
    exported = set(re.findall(r"\bJava_com_nvidia_spark_rapids_jni_\w+",
                              nm.stdout))
    expected = binding_symbols(JAX_BINDING.read_text())
    assert len(expected) == 128
    assert exported == expected
    assert binding_symbols(PORT_BINDING.read_text()) == expected


def test_library_and_builder_name_only_the_port():
    builder = Path(jni_native.__file__).read_text()
    source = PORT_BINDING.read_text()
    for text in (builder, source):
        assert not re.search(r"\bspark_rapids_tpu\.", text)
    assert "spark_rapids_tpu_torch.shim.jni_entry" in source
    assert not re.search(r"jax|xla", source, re.IGNORECASE)
    import_jax = subprocess.run(
        [sys.executable, "-c",
         "import sys; import spark_rapids_tpu_torch.shim.jni_native; "
         "assert 'jax' not in sys.modules"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert import_jax.returncode == 0, import_jax.stderr[-2000:]


def test_library_pins_the_building_interpreter(library):
    """The building Python's path is compiled in: the embedded
    interpreter does not look python3 up on the JVM's PATH."""
    assert sys.executable.encode() in library.read_bytes()


def test_no_jni_h_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARK_RAPIDS_JDK", str(tmp_path))
    monkeypatch.setattr(jni_native, "embedded_jdk", lambda: None)
    with pytest.raises(jni_native.JniBuildError, match="no jni.h"):
        jni_native.build_jni_library()


def test_failed_compile_raises_with_gpp_message(monkeypatch, tmp_path):
    """A source g++ refuses raises JniBuildError carrying g++'s own
    diagnostic, and leaves no library behind."""
    try:
        jdk = jni_native.find_jdk()
    except jni_native.JniBuildError as e:
        pytest.skip(str(e))
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    monkeypatch.setenv("SPARK_RAPIDS_JDK", str(jdk))
    src = tmp_path / "src"
    src.mkdir()
    (src / jni_native.SOURCE).write_text(textwrap.dedent("""\
        #include <jni.h>
        int broken( { return undeclared_name; }
        """))
    monkeypatch.setattr(jni_native, "JNI_SRC", src)
    monkeypatch.setattr(jni_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(jni_native.JniBuildError) as info:
        jni_native.build_jni_library()
    assert "g++ failed" in str(info.value)
    assert "error:" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))


def _reset_entries():
    J._INITIALIZED = False
    platform.set_entry_device("cuda")


def test_telemetry_entries_follow_initialize(monkeypatch):
    """SPARK_RAPIDS_TPU_PLATFORM=cpu, initialize(), then the three
    telemetry entries with no device argument: they answer for the CPU
    that initialize() chose, as the JAX package's do."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", "cpu")
    _reset_entries()
    JJ.initialize()
    J.initialize()
    try:
        assert J.telemetry_device_count() == 1
        assert (J.telemetry_device_name(0) == JJ.telemetry_device_name(0)
                == "cpu:cpu")
        assert (J.telemetry_snapshot_packed(0)
                == JJ.telemetry_snapshot_packed(0) == [-1] * 7)
    finally:
        J.shutdown()
        JJ.shutdown()
        _reset_entries()
    assert platform.entry_device() == "cuda"


def test_telemetry_entries_default_to_the_card():
    """Without initialize() the entries' device is the card: on a host
    with none, the telemetry entries raise rather than answer for the
    CPU."""
    _reset_entries()
    import torch
    if torch.cuda.is_available():
        assert J.telemetry_device_name(0).startswith("gpu:")
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        J.telemetry_device_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        J.telemetry_device_name(0)


def test_telemetry_entries_equal_the_jax_packages_in_a_fresh_process():
    """The minimal input in a fresh interpreter, where the JAX package's
    CPU backend has its one device: both packages' three answers are
    equal (1, "cpu:cpu", [-1] * 7)."""
    script = textwrap.dedent("""\
        from spark_rapids_tpu.shim import jni_entry as JJ
        from spark_rapids_tpu_torch.shim import jni_entry as J
        answers = []
        for mod in (JJ, J):
            mod.initialize()
            answers.append((mod.telemetry_device_count(),
                            mod.telemetry_device_name(0),
                            mod.telemetry_snapshot_packed(0)))
        assert answers[0] == answers[1] == (1, "cpu:cpu", [-1] * 7), answers
        print("ok")
        """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(SPARK_RAPIDS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.splitlines()[-1] == "ok"
