"""The port's JNI library: how a JVM drives spark_rapids_tpu_torch.

``build_jni_library()`` compiles ``csrc/jni/spark_rapids_tpu_torch_jni.cpp``
with g++ into ``build/jni/libspark_rapids_tpu_torch_jni-<hash>.so`` at
the repository root (listed in .gitignore) on first use.  The library
embeds CPython, imports ``spark_rapids_tpu_torch.shim.jni_entry`` and
exports the ``Java_com_nvidia_spark_rapids_jni_*`` functions that the
Java classes (``com.nvidia.spark.rapids.jni``) declare as native; a JVM
loads it with ``System.load(<path>)``.  The embedded interpreter is
pinned to the Python that built the library (``sys.executable``, passed
as ``-DSRT_PYTHON_EXECUTABLE``), so neither the import nor the rank
processes of the mesh entries depend on the JVM's PATH.

``jni.h`` comes from ``SPARK_RAPIDS_JDK`` when that JDK has one, else
from bazel's embedded JDK, which ``bazel --batch version`` unpacks once
under ``$HOME/.cache/bazel``.  Python's headers and ``LIBDIR`` come from
``sysconfig``.  A missing ``jni.h`` or a failed g++ raises
``JniBuildError`` with g++'s message: there is no fallback.  All of
this is host code; the entries reach the card through ``jni_entry``."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional

from spark_rapids_tpu_torch.utils import native as _native

JNI_SRC = Path(__file__).resolve().parents[1] / "csrc" / "jni"
SOURCE = "spark_rapids_tpu_torch_jni.cpp"
BUILD_DIR = _native.BUILD_DIR.parent / "jni"
NAME = "spark_rapids_tpu_torch_jni"


class JniBuildError(RuntimeError):
    """No jni.h, or g++ refused the JNI source (its message follows)."""


def _bazel_jdks():
    # an install base is named by its 32-digit MD5; bazel unpacks into a
    # temporary sibling first, which another process may be filling
    pattern = "_bazel_*/install/*/embedded_tools/jdk"
    return sorted(p for p in (Path.home() / ".cache" / "bazel").glob(pattern)
                  if re.fullmatch(r"[0-9a-f]{32}", p.parents[1].name))


def embedded_jdk() -> Optional[Path]:
    """Bazel's embedded JDK (it ships jni.h and a JRE), unpacked by one
    ``bazel --batch version`` when it is not yet; None without bazel."""
    jdks = _bazel_jdks()
    if not jdks and shutil.which("bazel"):
        subprocess.run(["bazel", "--batch", "version"],
                       cwd=tempfile.gettempdir(), capture_output=True,
                       timeout=300)
        jdks = _bazel_jdks()
    return jdks[0] if jdks else None


def find_jdk() -> Path:
    """The JDK whose include/jni.h the library is built against."""
    override = os.environ.get("SPARK_RAPIDS_JDK", "")
    if override and (Path(override) / "include" / "jni.h").exists():
        return Path(override)
    jdk = embedded_jdk()
    if jdk is None or not (jdk / "include" / "jni.h").exists():
        raise JniBuildError(
            "no jni.h found: set SPARK_RAPIDS_JDK to a JDK, or install "
            "bazel (its embedded JDK ships one)")
    return jdk


def find_java() -> Optional[str]:
    """A JVM to load the library with: SPARK_RAPIDS_JAVA, then java on
    PATH, then bazel's embedded JRE; None when there is none."""
    override = os.environ.get("SPARK_RAPIDS_JAVA", "")
    if override:
        return override
    on_path = shutil.which("java")
    if on_path:
        return on_path
    jdk = embedded_jdk()
    java = jdk / "bin" / "java" if jdk is not None else None
    return str(java) if java is not None and java.exists() else None


def build_jni_library() -> Path:
    """Build the port's JNI library unless it is built already; return
    its path.  The name hashes the source, native/kudo_native.hpp (the
    C++ kudo engine it includes), the JDK, Python's paths and the
    pinned interpreter."""
    jdk = find_jdk()
    libdir = sysconfig.get_config_var("LIBDIR")
    flags = (f"-I{jdk / 'include'}", f"-I{jdk / 'include' / 'linux'}",
             f"-I{sysconfig.get_paths()['include']}",
             f"-I{_native.NATIVE_SRC}",
             f"-DSRT_PYTHON_EXECUTABLE={json.dumps(sys.executable)}")
    libs = (f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-lpython3.12")
    try:
        return _native.build_library(
            NAME, SOURCE, headers=(_native.NATIVE_SRC / "kudo_native.hpp",),
            flags=flags, libs=libs, root=JNI_SRC, build_dir=BUILD_DIR)
    except subprocess.CalledProcessError as e:
        raise JniBuildError(f"g++ failed on {JNI_SRC / SOURCE}:\n"
                            f"{e.stderr}") from e
