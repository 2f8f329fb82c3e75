// JNI binding for spark_rapids_tpu_torch: real JVM -> JNI -> embedded
// CPython -> PyTorch runtime (CUDA kernels on the card, their plain
// versions on the host).
//
// This is the L4 layer of the reference architecture: the reference's
// *Jni.cpp files unwrap jlong column handles, call the native op, and
// wrap the result back into a jlong
// (src/main/cpp/src/hash/HashJni.cpp:31-46).  Here the "native runtime"
// is the PyTorch process: the library embeds CPython once per JVM,
// routes every call through spark_rapids_tpu_torch.shim.jni_entry (flat
// primitives-and-handles functions), and maps Python exceptions to
// java.lang.RuntimeException with the formatted message.  It exports
// the same Java_com_nvidia_spark_rapids_jni_* symbols, with the same JNI
// signatures, as the reference package's binding
// (native/jni/spark_rapids_tpu_jni.cpp), so one set of Java classes
// loads either library.  It holds no CUDA code: the entries reach the
// card through jni_entry.
//
// The interpreter is pinned: CPython starts as the Python the library
// was built with (SRT_PYTHON_EXECUTABLE, a -D define set by the
// builder), so its sys.path and sys.executable -- which the mesh
// entries' rank processes start -- do not depend on the JVM's PATH.
//
// Threading: JNI entry points can arrive on any JVM thread;
// PyGILState_Ensure/Release pairs make each call GIL-correct.  After
// initialization the embedding thread RELEASES the GIL so JVM threads
// never deadlock against it.
//
// Build: spark_rapids_tpu_torch.shim.jni_native.build_jni_library()
// (needs jni.h -- bazel's embedded JDK ships it -- and libpython3.12).

#include <dlfcn.h>
#include <jni.h>

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "kudo_native.hpp"  // native/, on the include path

#ifndef SRT_PYTHON_EXECUTABLE
#error "build with -DSRT_PYTHON_EXECUTABLE=\"<path of python3>\""
#endif

namespace {

PyObject* g_entry = nullptr;   // spark_rapids_tpu_torch.shim.jni_entry
std::once_flag g_init_flag;
std::string g_init_error;

void throw_java(JNIEnv* env, const char* msg) {
  jclass cls = env->FindClass("java/lang/RuntimeException");
  if (cls != nullptr) env->ThrowNew(cls, msg);
}

// Format the pending Python exception into a string and clear it.
// Formats the pending Python error as "TypeName: message".  When
// row_index is non-null it receives the exception's integer row_index
// attribute (the ExceptionWithRowIndex family carries the first
// failing row there), or -1 when absent — so the Java side gets the
// index as a field, never by parsing the message.
std::string pending_python_error(long* row_index = nullptr) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string out = "python error";
  if (row_index != nullptr) {
    *row_index = -1;
    if (value != nullptr && PyObject_HasAttrString(value, "row_index")) {
      PyObject* ri = PyObject_GetAttrString(value, "row_index");
      if (ri != nullptr) {
        long v = PyLong_AsLong(ri);
        if (!(v == -1 && PyErr_Occurred())) *row_index = v;
        PyErr_Clear();
        Py_DECREF(ri);
      } else {
        PyErr_Clear();
      }
    }
  }
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) {
        out = c;
        if (type != nullptr) {
          PyObject* tn = PyObject_GetAttrString(type, "__name__");
          const char* tc = tn ? PyUnicode_AsUTF8(tn) : nullptr;
          if (tc != nullptr) out = std::string(tc) + ": " + out;
          Py_XDECREF(tn);
        }
      }
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return out;
}

void do_initialize() {
  // Two configurations: either this library boots CPython
  // itself (owns the GIL after Py_InitializeEx and must SaveThread on
  // every exit), or another component in the same JVM process already
  // embedded Python — then the GIL must be ACQUIRED here via
  // PyGILState_Ensure/Release and SaveThread must NOT run (it would
  // release a thread state this code does not own).
  bool we_booted = !Py_IsInitialized();
  PyGILState_STATE gil_state = PyGILState_UNLOCKED;
  if (we_booted) {
    // System.load() binds our DT_NEEDED libpython with RTLD_LOCAL, so
    // CPython extension modules (math, numpy core, ...) — which do not
    // link libpython themselves — would fail to resolve Py* symbols.
    // Re-open libpython with RTLD_GLOBAL to promote its symbols.
    if (dlopen("libpython3.12.so", RTLD_NOW | RTLD_GLOBAL) == nullptr) {
      dlopen("libpython3.12.so.1.0", RTLD_NOW | RTLD_GLOBAL);
    }
    // Start as the building Python, not as whatever python3 the JVM's
    // PATH finds: its executable fixes sys.path (a virtual
    // environment's site-packages included) and sys.executable, which
    // the mesh entries' rank processes run.
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    config.install_signal_handlers = 0;  // leave signals to the JVM
    PyStatus status = PyConfig_SetBytesString(&config, &config.executable,
                                              SRT_PYTHON_EXECUTABLE);
    if (!PyStatus_Exception(status)) {
      status = Py_InitializeFromConfig(&config);
    }
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      g_init_error = std::string("embedded CPython (") +
                     SRT_PYTHON_EXECUTABLE + ") failed to start: " +
                     (status.err_msg ? status.err_msg : "unknown error");
      return;
    }
  } else {
    gil_state = PyGILState_Ensure();
  }
  auto release_gil = [&]() {
    if (we_booted) {
      // Release the GIL taken by Py_InitializeEx so JVM threads can
      // enter; never exit init still holding it.
      PyEval_SaveThread();
    } else {
      PyGILState_Release(gil_state);
    }
  };
  // Runtime root: env override first, else the JVM's working directory.
  const char* root = std::getenv("SPARK_RAPIDS_TPU_ROOT");
  std::string root_s = root ? root : ".";
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  if (sys_path != nullptr) {
    PyObject* p = PyUnicode_FromString(root_s.c_str());
    PyList_Insert(sys_path, 0, p);
    Py_DECREF(p);
  }
  PyObject* mod = PyImport_ImportModule(
      "spark_rapids_tpu_torch.shim.jni_entry");
  if (mod == nullptr) {
    g_init_error = "import jni_entry failed: " + pending_python_error();
    release_gil();
    return;
  }
  PyObject* r = PyObject_CallMethod(mod, "initialize", nullptr);
  if (r == nullptr) {
    g_init_error = "jni_entry.initialize failed: " + pending_python_error();
    Py_DECREF(mod);
    release_gil();
    return;
  }
  Py_DECREF(r);
  g_entry = mod;  // keep the reference for the life of the JVM
  release_gil();
}

// Ensure the interpreter is up; returns false (with a Java exception
// pending) on failure.  Safe to call from any JVM thread.
bool ensure_runtime(JNIEnv* env) {
  std::call_once(g_init_flag, do_initialize);
  if (g_entry == nullptr) {
    throw_java(env, g_init_error.empty()
                        ? "spark_rapids_tpu_torch runtime init failed"
                        : g_init_error.c_str());
    return false;
  }
  return true;
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

// ---- JNI <-> Python converters (GIL must be held) -------------------

PyObject* longs_to_pylist(JNIEnv* env, jlongArray arr) {
  jsize n = env->GetArrayLength(arr);
  jlong* elems = env->GetLongArrayElements(arr, nullptr);
  PyObject* list = PyList_New(n);
  for (jsize i = 0; i < n; ++i) {
    PyList_SET_ITEM(list, i, PyLong_FromLongLong(elems[i]));
  }
  env->ReleaseLongArrayElements(arr, elems, JNI_ABORT);
  return list;
}

PyObject* ints_to_pylist(JNIEnv* env, jintArray arr) {
  jsize n = env->GetArrayLength(arr);
  jint* elems = env->GetIntArrayElements(arr, nullptr);
  PyObject* list = PyList_New(n);
  for (jsize i = 0; i < n; ++i) {
    PyList_SET_ITEM(list, i, PyLong_FromLong(elems[i]));
  }
  env->ReleaseIntArrayElements(arr, elems, JNI_ABORT);
  return list;
}

PyObject* doubles_to_pylist(JNIEnv* env, jdoubleArray arr) {
  jsize n = env->GetArrayLength(arr);
  jdouble* elems = env->GetDoubleArrayElements(arr, nullptr);
  PyObject* list = PyList_New(n);
  for (jsize i = 0; i < n; ++i) {
    PyList_SET_ITEM(list, i, PyFloat_FromDouble(elems[i]));
  }
  env->ReleaseDoubleArrayElements(arr, elems, JNI_ABORT);
  return list;
}

// Java String -> Python str via UTF-16 code units (NOT GetStringUTFChars,
// which yields JNI modified UTF-8 — CESU-8 surrogate pairs for non-BMP
// chars that PyUnicode_FromString rejects).
PyObject* jstring_to_py(JNIEnv* env, jstring js) {
  jsize len = env->GetStringLength(js);
  const jchar* chars = env->GetStringChars(js, nullptr);
  PyObject* s = PyUnicode_DecodeUTF16(
      reinterpret_cast<const char*>(chars),
      static_cast<Py_ssize_t>(len) * 2, nullptr,
      nullptr /* native byte order */);
  env->ReleaseStringChars(js, chars);
  if (s == nullptr) {  // lone surrogates etc: substitute None
    PyErr_Clear();
    Py_RETURN_NONE;
  }
  return s;
}

PyObject* strings_to_pylist(JNIEnv* env, jobjectArray arr) {
  jsize n = env->GetArrayLength(arr);
  PyObject* list = PyList_New(n);
  for (jsize i = 0; i < n; ++i) {
    jstring js = static_cast<jstring>(env->GetObjectArrayElement(arr, i));
    if (js == nullptr) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(list, i, Py_None);
      continue;
    }
    PyList_SET_ITEM(list, i, jstring_to_py(env, js));
    env->DeleteLocalRef(js);
  }
  return list;
}

// The reference's OOM taxonomy crosses JNI as typed unchecked
// exceptions looked up by name (SparkResourceAdaptorJni.cpp:49-54);
// the runtime's Python exceptions carry the same class names, so the
// shim re-throws any "<TypeName>: msg" whose class exists under the
// package — no hardcoded list to drift from the Python taxonomy
// (unknown/unloadable names fall back to RuntimeException).
void throw_java_typed(JNIEnv* env, const std::string& formatted,
                      long row_index = -1) {
  // pending_python_error formats as "TypeName: message"
  size_t colon = formatted.find(": ");
  if (colon != std::string::npos && colon > 0) {
    std::string tname = formatted.substr(0, colon);
    bool ident = true;
    for (char ch : tname) {
      if (!((ch >= 'A' && ch <= 'Z') || (ch >= 'a' && ch <= 'z') ||
            (ch >= '0' && ch <= '9'))) {
        ident = false;
        break;
      }
    }
    if (ident) {
      std::string cls =
          std::string("com/nvidia/spark/rapids/jni/") + tname;
      jclass jc = env->FindClass(cls.c_str());
      if (jc != nullptr) {
        const char* msg = formatted.c_str() + colon + 2;
        // ExceptionWithRowIndex family: construct via (String, int)
        // so getRowIndex() reports the field the runtime set — the
        // message is never parsed.
        if (row_index >= 0) {
          jmethodID ctor =
              env->GetMethodID(jc, "<init>", "(Ljava/lang/String;I)V");
          if (ctor != nullptr) {
            jstring jmsg = env->NewStringUTF(msg);
            if (jmsg != nullptr) {
              jobject exc = env->NewObject(
                  jc, ctor, jmsg, static_cast<jint>(row_index));
              if (exc != nullptr &&
                  env->Throw(static_cast<jthrowable>(exc)) == 0) {
                return;
              }
            }
          }
          env->ExceptionClear();  // no such ctor / OOM: plain path
        }
        // ThrowNew fails for non-Throwable name collisions; fall back
        // so a Python error NEVER goes unreported to the JVM
        if (env->ThrowNew(jc, msg) == 0) {
          return;
        }
        env->ExceptionClear();
      } else {
        env->ExceptionClear();  // no such class
      }
    }
  }
  throw_java(env, formatted.c_str());
}

// Call g_entry.<fn>(*args); steals `args` (a tuple).  On Python error:
// clears it, throws the mapped Java exception, returns nullptr.
// args==NULL (a failed Py_BuildValue, e.g. modified-UTF-8 input) is
// handled here once so no call site can feed Py_DECREF a null.
PyObject* call_entry(JNIEnv* env, const char* fn, PyObject* args) {
  if (args == nullptr) {
    long row = -1;
    std::string msg = pending_python_error(&row);
    throw_java_typed(env, msg, row);
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(g_entry, fn);
  if (f == nullptr) {
    Py_DECREF(args);
    throw_java(env, (std::string("no entry function ") + fn).c_str());
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (r == nullptr) {
    long row = -1;
    std::string msg = pending_python_error(&row);
    throw_java_typed(env, msg, row);
    return nullptr;
  }
  return r;
}

jlong as_jlong(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return 0;
  jlong v = static_cast<jlong>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  if (PyErr_Occurred() != nullptr) {  // non-int return: surface, clear
    throw_java(env, pending_python_error().c_str());
    return 0;
  }
  return v;
}

jint as_jint(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return 0;
  jint v = static_cast<jint>(PyLong_AsLong(r));
  Py_DECREF(r);
  if (PyErr_Occurred() != nullptr) {
    throw_java(env, pending_python_error().c_str());
    return 0;
  }
  return v;
}

jlongArray as_jlong_array(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return nullptr;
  Py_ssize_t n = PyList_Size(r);
  jlongArray arr = env->NewLongArray(static_cast<jsize>(n));
  if (arr != nullptr) {
    jlong* buf = env->GetLongArrayElements(arr, nullptr);
    for (Py_ssize_t i = 0; i < n; ++i) {
      buf[i] = PyLong_AsLongLong(PyList_GET_ITEM(r, i));
    }
    env->ReleaseLongArrayElements(arr, buf, 0);
  }
  Py_DECREF(r);
  if (PyErr_Occurred() != nullptr) {  // non-int element
    throw_java(env, pending_python_error().c_str());
    return nullptr;
  }
  return arr;
}

PyObject* bytes_to_py(JNIEnv* env, jbyteArray arr) {
  jsize n = env->GetArrayLength(arr);
  jbyte* elems = env->GetByteArrayElements(arr, nullptr);
  PyObject* b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(elems), n);
  env->ReleaseByteArrayElements(arr, elems, JNI_ABORT);
  return b;
}

jbyteArray as_jbyte_array(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return nullptr;
  if (!PyBytes_Check(r)) {
    Py_DECREF(r);
    throw_java(env, "entry function did not return bytes");
    return nullptr;
  }
  jsize n = static_cast<jsize>(PyBytes_GET_SIZE(r));
  jbyteArray arr = env->NewByteArray(n);
  if (arr != nullptr) {
    env->SetByteArrayRegion(
        arr, 0, n,
        reinterpret_cast<const jbyte*>(PyBytes_AS_STRING(r)));
  }
  Py_DECREF(r);
  return arr;
}

// Python str -> Java String via UTF-16 (NewStringUTF needs modified
// UTF-8, which PyUnicode_AsUTF8 does not produce for non-BMP chars).
jstring as_jstring(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return nullptr;
  PyObject* u16 = PyUnicode_AsEncodedString(r, "utf-16-le", "replace");
  Py_DECREF(r);
  if (u16 == nullptr) {
    PyErr_Clear();
    return env->NewString(nullptr, 0);
  }
  jstring js = env->NewString(
      reinterpret_cast<const jchar*>(PyBytes_AS_STRING(u16)),
      static_cast<jsize>(PyBytes_GET_SIZE(u16) / 2));
  Py_DECREF(u16);
  return js;
}

jobjectArray as_jstring_array(JNIEnv* env, PyObject* r) {
  if (r == nullptr) return nullptr;
  if (!PyList_Check(r)) {
    Py_DECREF(r);
    throw_java(env, "entry function did not return a list");
    return nullptr;
  }
  jsize n = static_cast<jsize>(PyList_GET_SIZE(r));
  jclass scls = env->FindClass("java/lang/String");
  jobjectArray arr = env->NewObjectArray(n, scls, nullptr);
  if (arr != nullptr) {
    for (jsize i = 0; i < n; ++i) {
      PyObject* item = PyList_GET_ITEM(r, i);
      Py_INCREF(item);
      jstring js = as_jstring(env, item);
      env->SetObjectArrayElement(arr, i, js);
      env->DeleteLocalRef(js);
    }
  }
  Py_DECREF(r);
  return arr;
}

}  // namespace

#define JNI_FN(cls, name) \
  JNIEXPORT JNICALL Java_com_nvidia_spark_rapids_jni_##cls##_##name

extern "C" {

// ------------------------------------------------------------ Runtime

void JNI_FN(TpuRuntime, initialize)(JNIEnv* env, jclass) {
  ensure_runtime(env);
}

void JNI_FN(TpuRuntime, shutdown)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "shutdown", PyTuple_New(0));
  Py_XDECREF(r);
}

jlongArray JNI_FN(TpuRuntime, runDistributedQ5)(JNIEnv* env, jclass,
                                                jint n_devices,
                                                jint rows,
                                                jint stores) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(iii)", (int)n_devices, (int)rows,
                                 (int)stores);
  return as_jlong_array(env,
                        call_entry(env, "flagship_q5_mesh", args));
}

jlongArray JNI_FN(TpuRuntime, runDistributedQ72)(JNIEnv* env, jclass,
                                                 jint n_devices,
                                                 jint cs_rows,
                                                 jint items) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(iii)", (int)n_devices,
                                 (int)cs_rows, (int)items);
  return as_jlong_array(env,
                        call_entry(env, "flagship_q72_mesh", args));
}

jint JNI_FN(TpuRuntime, liveHandles)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return -1;
  Gil gil;
  return as_jint(env, call_entry(env, "live_handles", PyTuple_New(0)));
}

// --------------------------------------------------------- TpuColumns

jlong JNI_FN(TpuColumns, fromLongs)(JNIEnv* env, jclass, jlongArray v) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = PyTuple_Pack(1, longs_to_pylist(env, v));
  Py_DECREF(PyTuple_GET_ITEM(args, 0));  // PyTuple_Pack incref'd it
  return as_jlong(env, call_entry(env, "from_longs", args));
}

jlong JNI_FN(TpuColumns, fromInts)(JNIEnv* env, jclass, jintArray v) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = ints_to_pylist(env, v);
  PyObject* args = PyTuple_Pack(1, lst);
  Py_DECREF(lst);
  return as_jlong(env, call_entry(env, "from_ints", args));
}

jlong JNI_FN(TpuColumns, fromDoubles)(JNIEnv* env, jclass,
                                      jdoubleArray v) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = doubles_to_pylist(env, v);
  PyObject* args = PyTuple_Pack(1, lst);
  Py_DECREF(lst);
  return as_jlong(env, call_entry(env, "from_doubles", args));
}

jlong JNI_FN(TpuColumns, fromStrings)(JNIEnv* env, jclass,
                                      jobjectArray v) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = strings_to_pylist(env, v);
  PyObject* args = PyTuple_Pack(1, lst);
  Py_DECREF(lst);
  return as_jlong(env, call_entry(env, "from_strings", args));
}

// Bulk string-column path: whole primitive arrays cross the boundary
// (chars byte[], LE int32 offsets int[], optional packed validity) —
// no per-element boxing (reference HashJni.cpp:31-46 discipline).

jlong JNI_FN(TpuColumns, fromStringsBulk)(JNIEnv* env, jclass,
                                          jbyteArray chars,
                                          jintArray offsets,
                                          jbyteArray validity) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* pchars = bytes_to_py(env, chars);
  // int[] -> raw LE bytes in one copy (x86/ARM LE hosts)
  jsize n_offs = env->GetArrayLength(offsets);
  jint* oelems = env->GetIntArrayElements(offsets, nullptr);
  PyObject* poffs = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(oelems),
      static_cast<Py_ssize_t>(n_offs) * 4);
  env->ReleaseIntArrayElements(offsets, oelems, JNI_ABORT);
  PyObject* pvalid;
  if (validity == nullptr) {
    Py_INCREF(Py_None);
    pvalid = Py_None;
  } else {
    pvalid = bytes_to_py(env, validity);
  }
  PyObject* args = Py_BuildValue("(NNN)", pchars, poffs, pvalid);
  return as_jlong(env, call_entry(env, "from_strings_bulk", args));
}

jbyteArray JNI_FN(TpuColumns, getStringChars)(JNIEnv* env, jclass,
                                              jlong handle) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return as_jbyte_array(env,
                        call_entry(env, "string_column_chars", args));
}

jbyteArray JNI_FN(TpuColumns, getStringOffsets)(JNIEnv* env, jclass,
                                                jlong handle) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return as_jbyte_array(
      env, call_entry(env, "string_column_offsets", args));
}

jlong JNI_FN(TpuColumns, gather)(JNIEnv* env, jclass, jlong values,
                                 jlong indices) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)values,
                                 (long long)indices);
  return as_jlong(env, call_entry(env, "gather", args));
}

void JNI_FN(TpuColumns, free)(JNIEnv* env, jclass, jlong handle) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "free",
                           Py_BuildValue("(L)", (long long)handle));
  Py_XDECREF(r);
}

// --------------------------------------------------------------- Hash

jlong JNI_FN(Hash, murmurHash32)(JNIEnv* env, jclass, jint seed,
                                 jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = longs_to_pylist(env, cols);
  PyObject* args = Py_BuildValue("(iN)", (int)seed, lst);
  return as_jlong(env, call_entry(env, "murmur_hash3_32", args));
}

jlong JNI_FN(Hash, xxHash64)(JNIEnv* env, jclass, jlong seed,
                             jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = longs_to_pylist(env, cols);
  PyObject* args = Py_BuildValue("(LN)", (long long)seed, lst);
  return as_jlong(env, call_entry(env, "xx_hash_64", args));
}

jlong JNI_FN(Hash, hiveHash)(JNIEnv* env, jclass, jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = longs_to_pylist(env, cols);
  PyObject* args = Py_BuildValue("(N)", lst);
  return as_jlong(env, call_entry(env, "hive_hash", args));
}

// ------------------------------------------------------ RowConversion

jlong JNI_FN(RowConversion, convertToRows)(JNIEnv* env, jclass,
                                           jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = longs_to_pylist(env, cols);
  PyObject* args = Py_BuildValue("(N)", lst);
  return as_jlong(env, call_entry(env, "convert_to_rows", args));
}

jlongArray JNI_FN(RowConversion, convertFromRows)(
    JNIEnv* env, jclass, jlong rows, jobjectArray type_ids,
    jintArray scales) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* tids = strings_to_pylist(env, type_ids);
  PyObject* scl = ints_to_pylist(env, scales);
  PyObject* args = Py_BuildValue("(LNN)", (long long)rows, tids, scl);
  return as_jlong_array(env,
                        call_entry(env, "convert_from_rows", args));
}

// -------------------------------------------------------- CastStrings

jlong JNI_FN(CastStrings, toInteger)(JNIEnv* env, jclass, jlong col,
                                     jboolean ansi, jboolean strip,
                                     jstring type_id) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* t = env->GetStringUTFChars(type_id, nullptr);
  PyObject* args = Py_BuildValue("(LsOO)", (long long)col, t,
                                 ansi ? Py_True : Py_False,
                                 strip ? Py_True : Py_False);
  env->ReleaseStringUTFChars(type_id, t);
  return as_jlong(env, call_entry(env, "string_to_integer", args));
}

jlong JNI_FN(CastStrings, toFloat)(JNIEnv* env, jclass, jlong col,
                                   jboolean ansi, jstring type_id) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* t = env->GetStringUTFChars(type_id, nullptr);
  PyObject* args = Py_BuildValue("(LsO)", (long long)col, t,
                                 ansi ? Py_True : Py_False);
  env->ReleaseStringUTFChars(type_id, t);
  return as_jlong(env, call_entry(env, "string_to_float", args));
}

jlong JNI_FN(CastStrings, fromFloat)(JNIEnv* env, jclass, jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)col);
  return as_jlong(env, call_entry(env, "float_to_string", args));
}

// ---------------------------------------------------------- JSONUtils

jlong JNI_FN(JSONUtils, getJsonObject)(JNIEnv* env, jclass, jlong col,
                                       jstring path) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* p = env->GetStringUTFChars(path, nullptr);
  PyObject* args = Py_BuildValue("(Ls)", (long long)col, p);
  env->ReleaseStringUTFChars(path, p);
  return as_jlong(env, call_entry(env, "get_json_object", args));
}

// ----------------------------------------------------------- ParseURI

static jlong parse_uri_component(JNIEnv* env, jlong col,
                                 const char* what, jboolean ansi) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LsO)", (long long)col, what,
                                 ansi ? Py_True : Py_False);
  return as_jlong(env, call_entry(env, "parse_uri", args));
}

jlong JNI_FN(ParseURI, parseProtocol)(JNIEnv* env, jclass, jlong col,
                                      jboolean ansi) {
  return parse_uri_component(env, col, "protocol", ansi);
}

jlong JNI_FN(ParseURI, parseHost)(JNIEnv* env, jclass, jlong col,
                                  jboolean ansi) {
  return parse_uri_component(env, col, "host", ansi);
}

jlong JNI_FN(ParseURI, parseQuery)(JNIEnv* env, jclass, jlong col,
                                   jboolean ansi) {
  return parse_uri_component(env, col, "query", ansi);
}

jlong JNI_FN(ParseURI, parsePath)(JNIEnv* env, jclass, jlong col,
                                  jboolean ansi) {
  return parse_uri_component(env, col, "path", ansi);
}

jlong JNI_FN(ParseURI, parseQueryWithKey)(JNIEnv* env, jclass,
                                          jlong col, jstring key,
                                          jboolean ansi) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* k = env->GetStringUTFChars(key, nullptr);
  PyObject* args = Py_BuildValue("(LsO)", (long long)col, k,
                                 ansi ? Py_True : Py_False);
  env->ReleaseStringUTFChars(key, k);
  return as_jlong(env,
                  call_entry(env, "parse_uri_query_with_key", args));
}

// ------------------------------------------- GpuSubstringIndexUtils

jlong JNI_FN(GpuSubstringIndexUtils, substringIndex)(
    JNIEnv* env, jclass, jlong col, jstring delim, jint count) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* d = env->GetStringUTFChars(delim, nullptr);
  PyObject* args = Py_BuildValue("(Lsi)", (long long)col, d,
                                 (int)count);
  env->ReleaseStringUTFChars(delim, d);
  return as_jlong(env, call_entry(env, "substring_index", args));
}

// -------------------------------------------------------- CharsetDecode

jlong JNI_FN(CharsetDecode, decodeToUTF8)(JNIEnv* env, jclass,
                                          jlong col, jstring charset,
                                          jstring on_error) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* cs = env->GetStringUTFChars(charset, nullptr);
  const char* oe = env->GetStringUTFChars(on_error, nullptr);
  PyObject* args = Py_BuildValue("(Lss)", (long long)col, cs, oe);
  env->ReleaseStringUTFChars(charset, cs);
  env->ReleaseStringUTFChars(on_error, oe);
  return as_jlong(env, call_entry(env, "charset_decode_to_utf8", args));
}

// --------------------------------------------------------------- ZOrder

jlong JNI_FN(ZOrder, interleaveBits)(JNIEnv* env, jclass,
                                     jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, cols));
  return as_jlong(env, call_entry(env, "interleave_bits", args));
}

jlong JNI_FN(ZOrder, hilbertIndex)(JNIEnv* env, jclass, jint num_bits,
                                   jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(iN)", (int)num_bits,
                                 longs_to_pylist(env, cols));
  return as_jlong(env, call_entry(env, "hilbert_index", args));
}

// ------------------------------------------------------------- CaseWhen

jlong JNI_FN(CaseWhen, selectFirstTrueIndex)(JNIEnv* env, jclass,
                                             jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, cols));
  return as_jlong(env, call_entry(env, "select_first_true_index",
                                  args));
}

// ------------------------------------------------------ NumberConverter

jlong JNI_FN(NumberConverter, convertCvCv)(JNIEnv* env, jclass,
                                           jlong col, jint from_base,
                                           jint to_base) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Lii)", (long long)col,
                                 (int)from_base, (int)to_base);
  return as_jlong(env, call_entry(env, "number_converter_convert",
                                  args));
}

// -------------------------------------------------------- DateTimeUtils

jlong JNI_FN(DateTimeUtils, truncate)(JNIEnv* env, jclass, jlong col,
                                      jstring component) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* c = env->GetStringUTFChars(component, nullptr);
  PyObject* args = Py_BuildValue("(Ls)", (long long)col, c);
  env->ReleaseStringUTFChars(component, c);
  return as_jlong(env, call_entry(env, "datetime_truncate", args));
}

jlong JNI_FN(DateTimeRebase, rebaseGregorianToJulian)(JNIEnv* env,
                                                      jclass,
                                                      jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LO)", (long long)col, Py_True);
  return as_jlong(env, call_entry(env, "datetime_rebase", args));
}

jlong JNI_FN(DateTimeRebase, rebaseJulianToGregorian)(JNIEnv* env,
                                                      jclass,
                                                      jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LO)", (long long)col, Py_False);
  return as_jlong(env, call_entry(env, "datetime_rebase", args));
}

// ------------------------------------------------------ JoinPrimitives

jlongArray JNI_FN(JoinPrimitives, sortMergeInnerJoin)(
    JNIEnv* env, jclass, jlongArray left, jlongArray right,
    jboolean nulls_equal) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NNO)", longs_to_pylist(env, left), longs_to_pylist(env, right),
      nulls_equal ? Py_True : Py_False);
  return as_jlong_array(env,
                        call_entry(env, "sort_merge_inner_join", args));
}

// ---------------------------------------------------------- BloomFilter

jlong JNI_FN(BloomFilter, create)(JNIEnv* env, jclass, jint num_hashes,
                                  jint num_longs, jint version) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(iii)", (int)num_hashes,
                                 (int)num_longs, (int)version);
  return as_jlong(env, call_entry(env, "bloom_filter_create", args));
}

jlong JNI_FN(BloomFilter, put)(JNIEnv* env, jclass, jlong bf,
                               jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)bf,
                                 (long long)col);
  return as_jlong(env, call_entry(env, "bloom_filter_put", args));
}

jlong JNI_FN(BloomFilter, probe)(JNIEnv* env, jclass, jlong bf,
                                 jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)bf,
                                 (long long)col);
  return as_jlong(env, call_entry(env, "bloom_filter_probe", args));
}

jlong JNI_FN(BloomFilter, merge)(JNIEnv* env, jclass,
                                 jlongArray bfs) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, bfs));
  return as_jlong(env, call_entry(env, "bloom_filter_merge", args));
}

jbyteArray JNI_FN(BloomFilter, serialize)(JNIEnv* env, jclass,
                                          jlong bf) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)bf);
  return as_jbyte_array(env,
                        call_entry(env, "bloom_filter_serialize",
                                   args));
}

jlong JNI_FN(BloomFilter, deserialize)(JNIEnv* env, jclass,
                                       jbyteArray data) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", bytes_to_py(env, data));
  return as_jlong(env,
                  call_entry(env, "bloom_filter_deserialize", args));
}

// --------------------------------------------------- Aggregation64Utils

jlong JNI_FN(Aggregation64Utils, extractChunk32From64bit)(
    JNIEnv* env, jclass, jlong col, jstring type_id, jint chunk) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* t = env->GetStringUTFChars(type_id, nullptr);
  PyObject* args = Py_BuildValue("(Lsi)", (long long)col, t,
                                 (int)chunk);
  env->ReleaseStringUTFChars(type_id, t);
  return as_jlong(env,
                  call_entry(env, "extract_chunk32_from_64bit", args));
}

jlongArray JNI_FN(Aggregation64Utils, assemble64FromSum)(
    JNIEnv* env, jclass, jlong low, jlong high, jstring type_id) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  const char* t = env->GetStringUTFChars(type_id, nullptr);
  PyObject* args = Py_BuildValue("(LLs)", (long long)low,
                                 (long long)high, t);
  env->ReleaseStringUTFChars(type_id, t);
  return as_jlong_array(env,
                        call_entry(env, "assemble64_from_sum", args));
}

// ---------------------------------------------------- RegexRewriteUtils

jlong JNI_FN(RegexRewriteUtils, literalRangePattern)(
    JNIEnv* env, jclass, jlong col, jstring literal, jint range_len,
    jint start, jint end) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  // user literals can hold non-BMP chars: UTF-16 marshalling, not
  // GetStringUTFChars (modified UTF-8 — see jstring_to_py)
  PyObject* args = Py_BuildValue(
      "(LNiii)", (long long)col, jstring_to_py(env, literal),
      (int)range_len, (int)start, (int)end);
  return as_jlong(env,
                  call_entry(env, "literal_range_pattern", args));
}

// -------------------------------------------------------- GpuTimeZoneDB

jlong JNI_FN(GpuTimeZoneDB, convertTimestampToUTC)(JNIEnv* env, jclass,
                                                   jlong col,
                                                   jstring zone) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* z = env->GetStringUTFChars(zone, nullptr);
  PyObject* args = Py_BuildValue("(LsO)", (long long)col, z, Py_True);
  env->ReleaseStringUTFChars(zone, z);
  return as_jlong(env, call_entry(env, "timezone_convert", args));
}

jlong JNI_FN(GpuTimeZoneDB, convertUTCTimestampToTimeZone)(
    JNIEnv* env, jclass, jlong col, jstring zone) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* z = env->GetStringUTFChars(zone, nullptr);
  PyObject* args = Py_BuildValue("(LsO)", (long long)col, z, Py_False);
  env->ReleaseStringUTFChars(zone, z);
  return as_jlong(env, call_entry(env, "timezone_convert", args));
}

// ----------------------------------------------------------- Arithmetic

jlong JNI_FN(Arithmetic, multiply)(JNIEnv* env, jclass, jlong lhs,
                                   jlong rhs, jboolean ansi,
                                   jboolean try_mode) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LLOO)", (long long)lhs,
                                 (long long)rhs,
                                 ansi ? Py_True : Py_False,
                                 try_mode ? Py_True : Py_False);
  return as_jlong(env, call_entry(env, "arithmetic_multiply", args));
}

jlong JNI_FN(Arithmetic, round)(JNIEnv* env, jclass, jlong col,
                                jint decimal_places, jstring mode) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* m = env->GetStringUTFChars(mode, nullptr);
  PyObject* args = Py_BuildValue("(Lis)", (long long)col,
                                 (int)decimal_places, m);
  env->ReleaseStringUTFChars(mode, m);
  return as_jlong(env, call_entry(env, "arithmetic_round", args));
}

// ------------------------------------------------------------ Histogram

jlong JNI_FN(Histogram, createHistogramIfValid)(JNIEnv* env, jclass,
                                                jlong values,
                                                jlong freqs) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)values,
                                 (long long)freqs);
  return as_jlong(env, call_entry(env, "histogram_create", args));
}

jlong JNI_FN(Histogram, percentileFromHistogram)(JNIEnv* env, jclass,
                                                 jlong histogram,
                                                 jdoubleArray pcts) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LN)", (long long)histogram,
                                 doubles_to_pylist(env, pcts));
  return as_jlong(env, call_entry(env, "histogram_percentile", args));
}

// ----------------------------------------------- JSONUtils (multi-path)

jlongArray JNI_FN(JSONUtils, getJsonObjectMultiplePaths)(
    JNIEnv* env, jclass, jlong col, jobjectArray paths,
    jlong mem_budget, jint parallel_override) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNLi)", (long long)col, strings_to_pylist(env, paths),
      (long long)mem_budget, (int)parallel_override);
  return as_jlong_array(
      env, call_entry(env, "get_json_object_multiple_paths", args));
}

// ---------------------------------------------- CastStrings (datetime+)

jlong JNI_FN(CastStrings, toDate)(JNIEnv* env, jclass, jlong col,
                                  jboolean ansi) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LO)", (long long)col,
                                 ansi ? Py_True : Py_False);
  return as_jlong(env, call_entry(env, "cast_strings_to_date", args));
}

jlong JNI_FN(CastStrings, fromLongToBinary)(JNIEnv* env, jclass,
                                            jlong col) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)col);
  return as_jlong(env, call_entry(env, "long_to_binary_string", args));
}

jlong JNI_FN(CastStrings, formatNumber)(JNIEnv* env, jclass, jlong col,
                                        jint digits) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)col, (int)digits);
  return as_jlong(env, call_entry(env, "format_number", args));
}

// ------------------------------------------------------------------ Map

jlong JNI_FN(Map, sortMapColumn)(JNIEnv* env, jclass, jlong col,
                                 jboolean descending) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LO)", (long long)col,
                                 descending ? Py_True : Py_False);
  return as_jlong(env, call_entry(env, "map_sort", args));
}

// -------------------------------------------------------------- Iceberg

jlong JNI_FN(IcebergBucket, bucket)(JNIEnv* env, jclass, jlong col,
                                    jint num_buckets) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)col,
                                 (int)num_buckets);
  return as_jlong(env, call_entry(env, "iceberg_bucket", args));
}

jlong JNI_FN(IcebergTruncate, truncate)(JNIEnv* env, jclass, jlong col,
                                        jint width) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)col, (int)width);
  return as_jlong(env, call_entry(env, "iceberg_truncate", args));
}

jlong JNI_FN(IcebergDateTimeUtil, transform)(JNIEnv* env, jclass,
                                             jlong col,
                                             jstring component) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* c = env->GetStringUTFChars(component, nullptr);
  PyObject* args = Py_BuildValue("(Ls)", (long long)col, c);
  env->ReleaseStringUTFChars(component, c);
  return as_jlong(env, call_entry(env, "iceberg_datetime", args));
}

// ------------------------------------------ HyperLogLogPlusPlusHostUDF

jlong JNI_FN(HyperLogLogPlusPlusHostUDF, reduce)(JNIEnv* env, jclass,
                                                 jlong col,
                                                 jint precision) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)col,
                                 (int)precision);
  return as_jlong(env, call_entry(env, "hllpp_reduce", args));
}

jlong JNI_FN(HyperLogLogPlusPlusHostUDF, estimate)(JNIEnv* env, jclass,
                                                   jlong sketches,
                                                   jint precision) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)sketches,
                                 (int)precision);
  return as_jlong(env, call_entry(env, "hllpp_estimate", args));
}

// -------------------------------------------------------- ParquetFooter

jbyteArray JNI_FN(ParquetFooter, readAndFilter)(
    JNIEnv* env, jclass, jbyteArray footer, jobjectArray keep_names,
    jboolean case_sensitive) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NNO)", bytes_to_py(env, footer),
      strings_to_pylist(env, keep_names),
      case_sensitive ? Py_True : Py_False);
  return as_jbyte_array(
      env, call_entry(env, "parquet_footer_read_and_filter", args));
}

// -------------------------------------------------------------- Version

jboolean JNI_FN(Version, isVanilla320)(JNIEnv* env, jclass,
                                       jint platform, jint major,
                                       jint minor, jint patch) {
  if (!ensure_runtime(env)) return JNI_FALSE;
  Gil gil;
  PyObject* r = call_entry(
      env, "version_is_vanilla_320",
      Py_BuildValue("(iiii)", (int)platform, (int)major, (int)minor,
                    (int)patch));
  if (r == nullptr) return JNI_FALSE;
  jboolean v = PyObject_IsTrue(r) ? JNI_TRUE : JNI_FALSE;
  Py_DECREF(r);
  return v;
}

// -------------------------------------------------- ThreadStateRegistry

void JNI_FN(ThreadStateRegistry, addThread)(JNIEnv* env, jclass,
                                            jlong native_id) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "registry_add_thread",
                           Py_BuildValue("(L)", (long long)native_id));
  Py_XDECREF(r);
}

void JNI_FN(ThreadStateRegistry, removeThread)(JNIEnv* env, jclass,
                                               jlong native_id) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "registry_remove_thread",
                           Py_BuildValue("(L)", (long long)native_id));
  Py_XDECREF(r);
}

jlongArray JNI_FN(ThreadStateRegistry, knownThreads)(JNIEnv* env,
                                                     jclass) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  return as_jlong_array(env, call_entry(env, "registry_known_threads",
                                        PyTuple_New(0)));
}

// --------------------------------------------------------- TaskPriority

jlong JNI_FN(TaskPriority, getTaskPriority)(JNIEnv* env, jclass,
                                            jlong attempt) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)attempt);
  return as_jlong(env, call_entry(env, "task_priority_get", args));
}

void JNI_FN(TaskPriority, taskDone)(JNIEnv* env, jclass,
                                    jlong attempt) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "task_priority_done",
                           Py_BuildValue("(L)", (long long)attempt));
  Py_XDECREF(r);
}

// ------------------------------------------------------------- Protobuf

PyObject* bools_to_pylist(JNIEnv* env, jbooleanArray arr) {
  jsize n = env->GetArrayLength(arr);
  jboolean* elems = env->GetBooleanArrayElements(arr, nullptr);
  PyObject* list = PyList_New(n);
  for (jsize i = 0; i < n; ++i) {
    PyObject* b = elems[i] ? Py_True : Py_False;
    Py_INCREF(b);
    PyList_SET_ITEM(list, i, b);
  }
  env->ReleaseBooleanArrayElements(arr, elems, JNI_ABORT);
  return list;
}

jlong JNI_FN(Protobuf, decodeToStruct)(JNIEnv* env, jclass, jlong col,
                                       jintArray field_numbers,
                                       jobjectArray type_ids,
                                       jintArray encodings,
                                       jbooleanArray required) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNNNN)", (long long)col, ints_to_pylist(env, field_numbers),
      strings_to_pylist(env, type_ids), ints_to_pylist(env, encodings),
      bools_to_pylist(env, required));
  return as_jlong(env,
                  call_entry(env, "protobuf_decode_to_struct", args));
}

// ----------------------------------------------- TpuColumns (children)

jlong JNI_FN(TpuColumns, getChild)(JNIEnv* env, jclass, jlong col,
                                   jint index) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)col, (int)index);
  return as_jlong(env, call_entry(env, "struct_child", args));
}

// --------------------------------------------------------- DecimalUtils

static jlongArray decimal_binop(JNIEnv* env, const char* op, jlong a,
                                jlong b, jint out_scale) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(sLLi)", op, (long long)a,
                                 (long long)b, (int)out_scale);
  return as_jlong_array(env, call_entry(env, "decimal128_binop", args));
}

jlongArray JNI_FN(DecimalUtils, multiply128)(JNIEnv* env, jclass,
                                             jlong a, jlong b,
                                             jint scale) {
  return decimal_binop(env, "multiply", a, b, scale);
}

jlongArray JNI_FN(DecimalUtils, divide128)(JNIEnv* env, jclass, jlong a,
                                           jlong b, jint scale) {
  return decimal_binop(env, "divide", a, b, scale);
}

jlongArray JNI_FN(DecimalUtils, add128)(JNIEnv* env, jclass, jlong a,
                                        jlong b, jint scale) {
  return decimal_binop(env, "add", a, b, scale);
}

jlongArray JNI_FN(DecimalUtils, subtract128)(JNIEnv* env, jclass,
                                             jlong a, jlong b,
                                             jint scale) {
  return decimal_binop(env, "sub", a, b, scale);
}

// ----------------------------------------------- TpuColumns (decimals)

jlong JNI_FN(TpuColumns, fromDecimals)(JNIEnv* env, jclass,
                                       jlongArray unscaled, jint scale,
                                       jstring type_id) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  const char* t = env->GetStringUTFChars(type_id, nullptr);
  PyObject* args = Py_BuildValue("(Nis)", longs_to_pylist(env, unscaled),
                                 (int)scale, t);
  env->ReleaseStringUTFChars(type_id, t);
  return as_jlong(env, call_entry(env, "from_decimals", args));
}

// ----------------------------------------------------------- DeviceAttr

jboolean JNI_FN(DeviceAttr, isIntegratedGPU)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return JNI_FALSE;
  Gil gil;
  PyObject* r = call_entry(env, "device_attr_is_integrated",
                           PyTuple_New(0));
  if (r == nullptr) return JNI_FALSE;
  jboolean v = PyObject_IsTrue(r) ? JNI_TRUE : JNI_FALSE;
  Py_DECREF(r);
  return v;
}

// ------------------------------------------------------------- Profiler

void JNI_FN(Profiler, nativeInit)(JNIEnv* env, jclass, jstring path,
                                  jint flush_period_millis,
                                  jboolean alloc_capture) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  const char* p = env->GetStringUTFChars(path, nullptr);
  PyObject* args = Py_BuildValue("(siO)", p,
                                 (int)flush_period_millis,
                                 alloc_capture ? Py_True : Py_False);
  env->ReleaseStringUTFChars(path, p);
  PyObject* r = call_entry(env, "profiler_init", args);
  Py_XDECREF(r);
}

void JNI_FN(Profiler, nativeStart)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "profiler_start", PyTuple_New(0));
  Py_XDECREF(r);
}

void JNI_FN(Profiler, nativeStop)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "profiler_stop", PyTuple_New(0));
  Py_XDECREF(r);
}

void JNI_FN(Profiler, nativeShutdown)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "profiler_shutdown", PyTuple_New(0));
  Py_XDECREF(r);
}

// ------------------------------------------------------------ HostTable

jlong JNI_FN(HostTable, fromTable)(JNIEnv* env, jclass,
                                   jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, cols));
  return as_jlong(env, call_entry(env, "host_table_from_table", args));
}

jlong JNI_FN(HostTable, sizeBytes)(JNIEnv* env, jclass, jlong handle) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return as_jlong(env, call_entry(env, "host_table_size_bytes", args));
}

jlongArray JNI_FN(HostTable, toDeviceColumns)(JNIEnv* env, jclass,
                                              jlong handle) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", (long long)handle);
  return as_jlong_array(env,
                        call_entry(env, "host_table_to_device", args));
}

void JNI_FN(HostTable, free)(JNIEnv* env, jclass, jlong handle) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "host_table_free",
                           Py_BuildValue("(L)", (long long)handle));
  Py_XDECREF(r);
}

// ------------------------------------------------------- KudoSerializer

jbyteArray JNI_FN(KudoSerializer, writeToStream)(JNIEnv* env, jclass,
                                                 jlongArray cols,
                                                 jint row_offset,
                                                 jint num_rows) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(Nii)", longs_to_pylist(env, cols),
                                 (int)row_offset, (int)num_rows);
  return as_jbyte_array(env, call_entry(env, "kudo_write", args));
}

jlongArray JNI_FN(KudoSerializer, mergeToTable)(JNIEnv* env, jclass,
                                                jbyteArray blob,
                                                jobjectArray type_ids,
                                                jintArray scales) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NNN)", bytes_to_py(env, blob),
      strings_to_pylist(env, type_ids), ints_to_pylist(env, scales));
  return as_jlong_array(env, call_entry(env, "kudo_merge", args));
}

// --- native host-table kudo: the GIL-FREE shuffle hot path ----------
//
// The reference's kudo write/merge is pure JVM (kudo/KudoSerializer
// .java:48-170, KudoTableMerger.java) so executor threads serialize
// shuffle blocks concurrently.  Here the equivalent: ONE crossing
// exports a table's host buffers into the C++ engine
// (native/kudo_native.hpp); after that, writeHostTable and
// mergeToHostTable are plain C++ — no Python, no GIL — and scale
// linearly with JVM threads.  hostTableToColumns crosses back once on
// the receive side to re-materialize device columns.

jlong JNI_FN(KudoSerializer, hostTableFromColumns)(JNIEnv* env, jclass,
                                                   jlongArray cols) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* r = call_entry(
      env, "export_kudo_host",
      Py_BuildValue("(N)", longs_to_pylist(env, cols)));
  if (r == nullptr) return 0;
  if (!PyList_Check(r) || PyList_GET_SIZE(r) < 2) {
    Py_DECREF(r);
    throw_java(env, "export_kudo_host returned malformed list");
    return 0;
  }
  auto get_long = [&](Py_ssize_t i) {
    return PyLong_AsLongLong(PyList_GET_ITEM(r, i));
  };
  auto t = std::make_unique<kudo::Table>();
  t->num_rows = get_long(0);
  long long n_flat = get_long(1);
  if (PyList_GET_SIZE(r) != 2 + 8 * n_flat) {
    Py_DECREF(r);
    throw_java(env, "export_kudo_host length mismatch");
    return 0;
  }
  t->cols.resize(n_flat);
  for (long long i = 0; i < n_flat; ++i) {
    Py_ssize_t base = 2 + 8 * i;
    kudo::Col& c = t->cols[i];
    c.kind = static_cast<int32_t>(get_long(base));
    c.item_size = static_cast<int32_t>(get_long(base + 1));
    c.num_children = static_cast<int32_t>(get_long(base + 2));
    const char* tid = PyUnicode_AsUTF8(PyList_GET_ITEM(r, base + 3));
    c.type_id = tid ? tid : "";
    PyErr_Clear();
    c.scale = static_cast<int32_t>(get_long(base + 4));
    PyObject* data = PyList_GET_ITEM(r, base + 5);
    PyObject* validity = PyList_GET_ITEM(r, base + 6);
    PyObject* offsets = PyList_GET_ITEM(r, base + 7);
    if (PyBytes_Check(data)) {
      const auto* p = reinterpret_cast<const uint8_t*>(
          PyBytes_AS_STRING(data));
      c.data.assign(p, p + PyBytes_GET_SIZE(data));
    }
    if (PyBytes_Check(validity)) {
      const auto* p = reinterpret_cast<const uint8_t*>(
          PyBytes_AS_STRING(validity));
      c.validity.assign(p, p + PyBytes_GET_SIZE(validity));
      c.has_validity = true;
    }
    if (PyBytes_Check(offsets)) {
      Py_ssize_t nb = PyBytes_GET_SIZE(offsets);
      if (nb % 4 != 0) {
        Py_DECREF(r);
        throw_java(env, "export_kudo_host offsets not int32-aligned");
        return 0;
      }
      c.offsets.resize(nb / 4);
      std::memcpy(c.offsets.data(), PyBytes_AS_STRING(offsets), nb);
      c.has_offsets = true;
    }
  }
  Py_DECREF(r);
  return reinterpret_cast<jlong>(t.release());
}

// Pure C++: callable concurrently from many JVM threads on one table.
jbyteArray JNI_FN(KudoSerializer, writeHostTable)(JNIEnv* env, jclass,
                                                  jlong table,
                                                  jint row_offset,
                                                  jint num_rows) {
  try {
    std::string s = kudo::write_table(
        *reinterpret_cast<kudo::Table*>(table), row_offset, num_rows);
    jbyteArray arr = env->NewByteArray(static_cast<jsize>(s.size()));
    if (arr != nullptr) {
      env->SetByteArrayRegion(
          arr, 0, static_cast<jsize>(s.size()),
          reinterpret_cast<const jbyte*>(s.data()));
    }
    return arr;
  } catch (const std::exception& e) {
    throw_java(env, e.what());
    return nullptr;
  }
}

// Pure C++ merge; schema (kinds/sizes/children + dtype tags) comes
// from an existing host table with the same column structure.
jlong JNI_FN(KudoSerializer, mergeToHostTable)(JNIEnv* env, jclass,
                                               jbyteArray blob,
                                               jlong schema_table) {
  try {
    auto* st = reinterpret_cast<kudo::Table*>(schema_table);
    jsize len = env->GetArrayLength(blob);
    std::vector<uint8_t> buf(static_cast<size_t>(len));
    env->GetByteArrayRegion(blob, 0, len,
                            reinterpret_cast<jbyte*>(buf.data()));
    std::vector<int32_t> kinds, items, nch;
    kinds.reserve(st->cols.size());
    for (const kudo::Col& c : st->cols) {
      kinds.push_back(c.kind);
      items.push_back(c.item_size);
      nch.push_back(c.num_children);
    }
    auto out = std::make_unique<kudo::Table>(kudo::merge_blocks(
        buf.data(), len, kinds.data(), items.data(), nch.data(),
        kinds.size()));
    for (size_t i = 0; i < out->cols.size(); ++i) {
      out->cols[i].type_id = st->cols[i].type_id;
      out->cols[i].scale = st->cols[i].scale;
    }
    return reinterpret_cast<jlong>(out.release());
  } catch (const std::exception& e) {
    throw_java(env, e.what());
    return 0;
  }
}

jlong JNI_FN(KudoSerializer, hostTableNumRows)(JNIEnv*, jclass,
                                               jlong table) {
  return reinterpret_cast<kudo::Table*>(table)->num_rows;
}

void JNI_FN(KudoSerializer, freeHostTable)(JNIEnv*, jclass,
                                           jlong table) {
  delete reinterpret_cast<kudo::Table*>(table);
}

jlongArray JNI_FN(KudoSerializer, hostTableToColumns)(JNIEnv* env,
                                                      jclass,
                                                      jlong table) {
  if (!ensure_runtime(env)) return nullptr;
  auto* t = reinterpret_cast<kudo::Table*>(table);
  Gil gil;
  PyObject* flat = PyList_New(static_cast<Py_ssize_t>(
      t->cols.size() * 8));
  for (size_t i = 0; i < t->cols.size(); ++i) {
    const kudo::Col& c = t->cols[i];
    Py_ssize_t base = static_cast<Py_ssize_t>(i) * 8;
    PyList_SET_ITEM(flat, base, PyLong_FromLong(c.kind));
    PyList_SET_ITEM(flat, base + 1, PyLong_FromLong(c.item_size));
    PyList_SET_ITEM(flat, base + 2, PyLong_FromLong(c.num_children));
    PyList_SET_ITEM(flat, base + 3,
                    PyUnicode_FromString(c.type_id.c_str()));
    PyList_SET_ITEM(flat, base + 4, PyLong_FromLong(c.scale));
    if (c.kind == kudo::LIST || c.kind == kudo::STRUCT) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(flat, base + 5, Py_None);
    } else {
      PyList_SET_ITEM(flat, base + 5, PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(c.data.data()),
          static_cast<Py_ssize_t>(c.data.size())));
    }
    if (c.has_validity) {
      PyList_SET_ITEM(flat, base + 6, PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(c.validity.data()),
          static_cast<Py_ssize_t>(c.validity.size())));
    } else {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(flat, base + 6, Py_None);
    }
    if (c.has_offsets) {
      PyList_SET_ITEM(flat, base + 7, PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(c.offsets.data()),
          static_cast<Py_ssize_t>(c.offsets.size() * 4)));
    } else {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(flat, base + 7, Py_None);
    }
  }
  PyObject* args = Py_BuildValue("(LN)",
                                 (long long)t->num_rows, flat);
  return as_jlong_array(
      env, call_entry(env, "columns_from_kudo_host", args));
}

// -------------------------------------------------------- StringUtils

jlong JNI_FN(StringUtils, randomUUIDs)(JNIEnv* env, jclass, jint rows,
                                       jlong seed) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(iL)", (int)rows, (long long)seed);
  return as_jlong(env, call_entry(env, "random_uuids", args));
}

// ----------------------------------------------------------- RmmSpark

void JNI_FN(RmmSpark, setEventHandler)(JNIEnv* env, jclass,
                                       jlong limit) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_set_event_handler",
                           Py_BuildValue("(L)", (long long)limit));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, clearEventHandler)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_clear_event_handler",
                           PyTuple_New(0));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, startDedicatedTaskThread)(JNIEnv* env, jclass,
                                                jlong tid, jlong task) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(
      env, "rmm_start_dedicated_task_thread",
      Py_BuildValue("(LL)", (long long)tid, (long long)task));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, taskDone)(JNIEnv* env, jclass, jlong task) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_task_done",
                           Py_BuildValue("(L)", (long long)task));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, forceRetryOOM)(JNIEnv* env, jclass, jlong tid,
                                     jint n) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(
      env, "rmm_force_retry_oom",
      Py_BuildValue("(Li)", (long long)tid, (int)n));
  Py_XDECREF(r);
}

jstring JNI_FN(RmmSpark, getStateOf)(JNIEnv* env, jclass, jlong tid) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  return as_jstring(env,
                    call_entry(env, "rmm_get_state_of",
                               Py_BuildValue("(L)", (long long)tid)));
}

jlong JNI_FN(RmmSpark, getCurrentThreadId)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  return as_jlong(env, call_entry(env, "rmm_current_thread_id",
                                  PyTuple_New(0)));
}

void JNI_FN(RmmSpark, currentThreadIsDedicatedToTask)(JNIEnv* env,
                                                      jclass,
                                                      jlong task) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_register_current_thread",
                           Py_BuildValue("(L)", (long long)task));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, forceSplitAndRetryOOM)(JNIEnv* env, jclass,
                                             jlong tid, jint n) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(
      env, "rmm_force_split_and_retry_oom",
      Py_BuildValue("(Li)", (long long)tid, (int)n));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, blockThreadUntilReady)(JNIEnv* env, jclass) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_block_thread_until_ready",
                           PyTuple_New(0));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, alloc)(JNIEnv* env, jclass, jlong nbytes) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_alloc",
                           Py_BuildValue("(L)", (long long)nbytes));
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, dealloc)(JNIEnv* env, jclass, jlong nbytes) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* r = call_entry(env, "rmm_dealloc",
                           Py_BuildValue("(L)", (long long)nbytes));
  Py_XDECREF(r);
}

// -------------------------------------------------------- TestSupport

void JNI_FN(TestSupport, assertTrue)(JNIEnv* env, jclass, jint cond,
                                     jstring msg) {
  if (cond != 0) return;
  const char* m = env->GetStringUTFChars(msg, nullptr);
  std::string s = std::string("assertion failed: ") + (m ? m : "");
  env->ReleaseStringUTFChars(msg, m);
  jclass cls = env->FindClass("java/lang/AssertionError");
  if (cls != nullptr) env->ThrowNew(cls, s.c_str());
}

jint JNI_FN(TestSupport, checkLongColumn)(JNIEnv* env, jclass,
                                          jlong col, jlongArray exp) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = longs_to_pylist(env, exp);
  PyObject* args = Py_BuildValue("(LN)", (long long)col, lst);
  return as_jint(env, call_entry(env, "check_long_column", args));
}

jint JNI_FN(TestSupport, checkIntColumn)(JNIEnv* env, jclass, jlong col,
                                         jintArray exp) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = ints_to_pylist(env, exp);
  PyObject* args = Py_BuildValue("(LN)", (long long)col, lst);
  return as_jint(env, call_entry(env, "check_int_column", args));
}

jint JNI_FN(TestSupport, checkStringColumn)(JNIEnv* env, jclass,
                                            jlong col,
                                            jobjectArray exp) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* lst = strings_to_pylist(env, exp);
  PyObject* args = Py_BuildValue("(LN)", (long long)col, lst);
  return as_jint(env, call_entry(env, "check_string_column", args));
}

jint JNI_FN(TestSupport, checkColumnsEqual)(JNIEnv* env, jclass,
                                            jlong a, jlong b) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)a, (long long)b);
  return as_jint(env, call_entry(env, "check_columns_equal", args));
}

jlong JNI_FN(TestSupport, makeMapColumn)(JNIEnv* env, jclass,
                                         jintArray offsets,
                                         jobjectArray keys,
                                         jobjectArray values) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NNN)", ints_to_pylist(env, offsets),
      strings_to_pylist(env, keys), strings_to_pylist(env, values));
  return as_jlong(env, call_entry(env, "make_map_column", args));
}

jlong JNI_FN(TestSupport, makeListOfInts)(JNIEnv* env, jclass,
                                          jintArray offsets,
                                          jlongArray values) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(NN)", ints_to_pylist(env, offsets),
                                 longs_to_pylist(env, values));
  return as_jlong(env, call_entry(env, "make_list_of_ints", args));
}

void JNI_FN(RmmSpark, shuffleThreadWorkingOnTasks)(JNIEnv* env, jclass,
                                                   jlongArray tasks) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, tasks));
  PyObject* r = call_entry(env, "rmm_shuffle_thread_working_on_tasks",
                           args);
  Py_XDECREF(r);
}

void JNI_FN(RmmSpark, poolThreadFinishedForTasks)(JNIEnv* env, jclass,
                                                  jlongArray tasks) {
  if (!ensure_runtime(env)) return;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", longs_to_pylist(env, tasks));
  PyObject* r = call_entry(env, "rmm_pool_thread_finished_for_tasks",
                           args);
  Py_XDECREF(r);
}

// ------------------------------------------------ list/map utilities

static jlong list_slice_impl(JNIEnv* env, jlong cv, jlong start,
                             jlong length, int start_is_col,
                             int length_is_col, jboolean check) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LLLiii)", (long long)cv, (long long)start, (long long)length,
      start_is_col, length_is_col, (int)check);
  return as_jlong(env, call_entry(env, "list_slice", args));
}

jlong JNI_FN(GpuListSliceUtils, listSlice)(JNIEnv* env, jclass,
                                           jlong cv, jint start,
                                           jint length,
                                           jboolean check) {
  return list_slice_impl(env, cv, start, length, 0, 0, check);
}

jlong JNI_FN(GpuListSliceUtils, listSliceSC)(JNIEnv* env, jclass,
                                             jlong cv, jint start,
                                             jlong length_cv,
                                             jboolean check) {
  return list_slice_impl(env, cv, start, length_cv, 0, 1, check);
}

jlong JNI_FN(GpuListSliceUtils, listSliceCS)(JNIEnv* env, jclass,
                                             jlong cv, jlong start_cv,
                                             jint length,
                                             jboolean check) {
  return list_slice_impl(env, cv, start_cv, length, 1, 0, check);
}

jlong JNI_FN(GpuListSliceUtils, listSliceCC)(JNIEnv* env, jclass,
                                             jlong cv, jlong start_cv,
                                             jlong length_cv,
                                             jboolean check) {
  return list_slice_impl(env, cv, start_cv, length_cv, 1, 1, check);
}

jboolean JNI_FN(MapUtils, isValidMap)(JNIEnv* env, jclass, jlong cv,
                                      jboolean throw_on_null) {
  if (!ensure_runtime(env)) return JNI_FALSE;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)cv,
                                 (int)throw_on_null);
  return as_jint(env, call_entry(env, "map_is_valid", args))
      ? JNI_TRUE : JNI_FALSE;
}

jlong JNI_FN(MapUtils, mapFromEntries)(JNIEnv* env, jclass, jlong cv,
                                       jboolean throw_on_null) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", (long long)cv,
                                 (int)throw_on_null);
  return as_jlong(env, call_entry(env, "map_from_entries_jni", args));
}

jlong JNI_FN(GpuMapZipWithUtils, mapZip)(JNIEnv* env, jclass,
                                         jlong m1, jlong m2) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  PyObject* args = Py_BuildValue("(LL)", (long long)m1, (long long)m2);
  return as_jlong(env, call_entry(env, "map_zip_jni", args));
}

// ------------------------------------------- ORC timezone extraction

jlongArray JNI_FN(OrcDstRuleExtractor, timezoneInfoPacked)(
    JNIEnv* env, jclass, jstring zone_id) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(N)", jstring_to_py(env, zone_id));
  return as_jlong_array(env,
                        call_entry(env, "orc_timezone_packed", args));
}

jobjectArray JNI_FN(OrcDstRuleExtractor, timezoneIds)(JNIEnv* env,
                                                      jclass) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  return as_jstring_array(
      env, call_entry(env, "all_timezone_ids", PyTuple_New(0)));
}

// --------------------------------------------- device telemetry (NVML)

// nvml subpackage: symbol names spelled out (JNI_FN assumes the flat
// package)

JNIEXPORT jint JNICALL
Java_com_nvidia_spark_rapids_jni_nvml_NVML_getDeviceCount(JNIEnv* env,
                                                          jclass) {
  if (!ensure_runtime(env)) return 0;
  Gil gil;
  return as_jint(env, call_entry(env, "telemetry_device_count",
                                 PyTuple_New(0)));
}

JNIEXPORT jlongArray JNICALL
Java_com_nvidia_spark_rapids_jni_nvml_NVML_getSnapshotPacked(
    JNIEnv* env, jclass, jint index) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(i)", (int)index);
  return as_jlong_array(
      env, call_entry(env, "telemetry_snapshot_packed", args));
}

JNIEXPORT jstring JNICALL
Java_com_nvidia_spark_rapids_jni_nvml_NVML_getDeviceName(JNIEnv* env,
                                                         jclass,
                                                         jint index) {
  if (!ensure_runtime(env)) return nullptr;
  Gil gil;
  PyObject* args = Py_BuildValue("(i)", (int)index);
  return as_jstring(env, call_entry(env, "telemetry_device_name",
                                    args));
}

}  // extern "C"
