"""PyTorch port: a real JVM drives spark_rapids_tpu_torch through the
port's own JNI library (shim/jni_native.build_jni_library).

The Java classes are emitted by scripts/gen_java_classes.py, run
unchanged: their goldens and surface sweeps are computed from the JAX
package, so each smoke holds the port, entry by entry through JNI, to
the reference.  The entries run on the CPU
(SPARK_RAPIDS_TPU_PLATFORM=cpu), and the mesh entries on four gloo CPU
ranks (SPARK_RAPIDS_TPU_CPU_DEVICES=4).  The last case runs with
PATH=/usr/bin:/bin, where python3 need not be the Python that built the
library: the library pins its interpreter, so the import and the rank
processes of distributed q5/q72 still start under the building Python.
The JVM is found as scripts/run_jni_smoke.sh finds it: SPARK_RAPIDS_JAVA,
then java on PATH, then bazel's embedded JRE."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from spark_rapids_tpu_torch.shim import jni_native

REPO = Path(__file__).resolve().parents[1]
PKG = "com.nvidia.spark.rapids.jni"


@pytest.fixture(scope="module")
def jvm(tmp_path_factory):
    """(java, the port's library, the emitted classes' directory)."""
    java = jni_native.find_java()
    if java is None:
        pytest.skip("no JVM: set SPARK_RAPIDS_JAVA, put java on PATH or "
                    "install bazel")
    lib = jni_native.build_jni_library()
    classes = tmp_path_factory.mktemp("java_classes")
    r = subprocess.run([sys.executable,
                        str(REPO / "scripts" / "gen_java_classes.py"),
                        str(classes)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return java, lib, classes


@pytest.mark.parametrize("test_class, ok_line, path", [
    ("JniSmokeTest", "JNI smoke: ALL OK", None),
    ("OomSmokeTest", "OOM smoke: ALL OK", None),
    ("BufnSmokeTest", "BUFN smoke: ALL OK", None),
    ("JniSmokeTest", "JNI smoke: ALL OK", "/usr/bin:/bin"),
], ids=["jni", "oom", "bufn", "jni_minimal_path"])
def test_jvm_smoke_against_the_port(jvm, test_class, ok_line, path,
                                    tmp_path):
    java, lib, classes = jvm
    env = dict(os.environ, SPARK_RAPIDS_TPU_PLATFORM="cpu",
               SPARK_RAPIDS_TPU_CPU_DEVICES="4",
               SPARK_RAPIDS_TPU_ROOT=str(REPO))
    if path is not None:
        env["PATH"] = path
    r = subprocess.run([java, "-cp", str(classes), f"{PKG}.{test_class}",
                        str(lib)],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=150)
    out = r.stdout.splitlines()
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-4000:]
    assert ok_line in out
    if test_class == "JniSmokeTest":
        assert "handle hygiene: zero leaks" in out
        assert any(line.startswith("distributed q5 from the JVM ok")
                   for line in out)
        assert any(line.startswith("distributed q72 from the JVM ok")
                   for line in out)
