// Minimal OpenCL-1.1-on-CPU implementation, purpose-built to run the
// reference binary (Scthe/cnn-Super-Resolution) as a parity ORACLE.
//
// Motivation (VERDICT round 1, "Next round #1b"): the environment has no
// OpenCL platform (ocl-icd loader reports 0 vendors, no POCL, no LLVM, no
// network), so the reference can't run as shipped. But its host code only
// touches 27 cl* entry points and its 11 kernels use a small OpenCL C
// subset — so instead of a full ICD we implement exactly that surface:
//
//  - host API: buffers/images are host allocations; the queue executes
//    synchronously in enqueue order; events are timing tokens.
//  - clBuildProgram compiles the UNMODIFIED .cl source as C++ via g++
//    (-shared -fPIC) against tools/reforacle/cl_compat.hpp, generates an
//    extern-C trampoline per __kernel by parsing the parameter list, and
//    dlopens the result. "-D FOO" build options pass straight to g++.
//  - clEnqueueNDRangeKernel walks the NDRange on the host thread. Kernels
//    whose source uses barrier() (sum.cl, squared_error.cl reductions) run
//    each work-group as ucontext coroutines — barrier() swaps back to the
//    round-robin scheduler, giving real OpenCL barrier semantics. All other
//    kernels take a plain-loop fast path.
//
// Single-threaded by design: the reference's one nondeterminism source
// (float atomic_add in backpropagate.cl:9-31) becomes exact, so minted
// goldens are bit-stable.
//
// This file is harness code for tests/golden minting, not framework code.
// Build: tools/reforacle/build_reference.sh

#include <CL/cl.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <ctime>
#include <string>
#include <vector>
#include <map>
#include <functional>

#include <dlfcn.h>
#include <ucontext.h>
#include <sys/stat.h>
#include <unistd.h>

#ifndef CNNSHIM_COMPAT_DIR
#error "build with -DCNNSHIM_COMPAT_DIR=\"/path/to/tools/reforacle\""
#endif

// ---------------------------------------------------------------------
// object definitions behind the opaque CL handles
// ---------------------------------------------------------------------

struct ShimImage {  // layout mirror of cl_compat.hpp's __shim_image
  int w, h;
  const unsigned char* rgba;
};

struct _cl_mem {
  size_t size = 0;
  char* data = nullptr;
  bool is_image = false;
  ShimImage img{0, 0, nullptr};
};

struct _cl_event {
  cl_ulong t0 = 0, t1 = 0;
};

struct KernelSig {
  std::string name;
  std::vector<char> kinds;        // 'P' global ptr, 'I' image, 'L' local, 'S' scalar
  std::vector<std::string> casts; // C++ cast text per arg
};

struct _cl_program {
  std::string source;
  std::string options;
  std::string build_log;
  void* dl = nullptr;
  bool uses_barrier = false;
  std::map<std::string, KernelSig> sigs;
  void (*bind_fn)(void*, void (*)(void*), void*) = nullptr;
};

struct KArg {
  char kind = 0;
  std::vector<char> bytes;
  size_t local_size = 0;
};

struct _cl_kernel {
  _cl_program* prog = nullptr;
  std::string name;
  void (*tramp)(void**) = nullptr;
  std::vector<KArg> args;
};

struct _cl_context {
  int dummy = 0;
};
struct _cl_command_queue {
  bool profiling = false;
};

static _cl_platform_id* const SHIM_PLATFORM = (_cl_platform_id*)0x1001;
static _cl_device_id* const SHIM_DEVICE = (_cl_device_id*)0x1002;

static cl_ulong now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (cl_ulong)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

// events are never released by the reference; hand them out from a ring
static _cl_event* alloc_event() {
  static _cl_event ring[8192];
  static size_t next = 0;
  _cl_event* e = &ring[next];
  next = (next + 1) % 8192;
  return e;
}

// ---------------------------------------------------------------------
// helpers: param info writers
// ---------------------------------------------------------------------
template <typename T>
static cl_int write_param(const T& v, size_t sz, void* p, size_t* szret) {
  if (p) {
    if (sz < sizeof(T)) return CL_INVALID_VALUE;
    memcpy(p, &v, sizeof(T));
  }
  if (szret) *szret = sizeof(T);
  return CL_SUCCESS;
}
static cl_int write_str(const char* s, size_t sz, void* p, size_t* szret) {
  size_t n = strlen(s) + 1;
  if (p) {
    if (sz < n) return CL_INVALID_VALUE;
    memcpy(p, s, n);
  }
  if (szret) *szret = n;
  return CL_SUCCESS;
}

// ---------------------------------------------------------------------
// platform / device
// ---------------------------------------------------------------------
extern "C" {

cl_int clGetPlatformIDs(cl_uint n, cl_platform_id* ids, cl_uint* nret) {
  if (ids && n >= 1) ids[0] = SHIM_PLATFORM;
  if (nret) *nret = 1;
  return CL_SUCCESS;
}

cl_int clGetPlatformInfo(cl_platform_id, cl_platform_info name, size_t sz,
                         void* p, size_t* szret) {
  switch (name) {
    case CL_PLATFORM_NAME:
      return write_str("cnnshim (CPU oracle)", sz, p, szret);
    case CL_PLATFORM_VENDOR:
      return write_str("cnn_sr reforacle", sz, p, szret);
    case CL_PLATFORM_VERSION:
      return write_str("OpenCL 1.1 cnnshim", sz, p, szret);
    default:
      return write_str("", sz, p, szret);
  }
}

cl_int clGetDeviceIDs(cl_platform_id, cl_device_type, cl_uint n,
                      cl_device_id* ids, cl_uint* nret) {
  if (ids && n >= 1) ids[0] = SHIM_DEVICE;
  if (nret) *nret = 1;
  return CL_SUCCESS;  // report the CPU as a GPU-typed device: the
                      // reference requests CL_DEVICE_TYPE_GPU only
}

cl_int clGetDeviceInfo(cl_device_id, cl_device_info name, size_t sz, void* p,
                       size_t* szret) {
  switch (name) {
    case CL_DEVICE_GLOBAL_MEM_SIZE:
      return write_param<cl_ulong>(4ull << 30, sz, p, szret);
    case CL_DEVICE_IMAGE_SUPPORT:
      return write_param<cl_bool>(CL_TRUE, sz, p, szret);
    case CL_DEVICE_MAX_WORK_GROUP_SIZE:
      return write_param<size_t>(256, sz, p, szret);
    case CL_DEVICE_ADDRESS_BITS:
      // 32, not 64: Context.cpp:check_work_parameters computes
      // 1<<address_bits in a long long — 64 would overflow to UB
      return write_param<cl_uint>(32, sz, p, szret);
    case CL_DEVICE_MAX_WORK_ITEM_SIZES: {
      size_t v[3] = {256, 256, 64};
      if (p) {
        if (sz < sizeof(v)) return CL_INVALID_VALUE;
        memcpy(p, v, sizeof(v));
      }
      if (szret) *szret = sizeof(v);
      return CL_SUCCESS;
    }
    case CL_DEVICE_TYPE:
      return write_param<cl_device_type>(CL_DEVICE_TYPE_GPU, sz, p, szret);
    case CL_DEVICE_LOCAL_MEM_SIZE:
      return write_param<cl_ulong>(48 << 10, sz, p, szret);
    case CL_DEVICE_LOCAL_MEM_TYPE:
      return write_param<cl_device_local_mem_type>(CL_LOCAL, sz, p, szret);
    case CL_DEVICE_MAX_COMPUTE_UNITS:
      return write_param<cl_uint>(1, sz, p, szret);
    case CL_DEVICE_NAME:
      return write_str("cnnshim CPU oracle device", sz, p, szret);
    default:
      // zero-fill unknown queries
      if (p) memset(p, 0, sz);
      if (szret) *szret = sz;
      return CL_SUCCESS;
  }
}

// ---------------------------------------------------------------------
// context / queue
// ---------------------------------------------------------------------
cl_context clCreateContext(const cl_context_properties*, cl_uint,
                           const cl_device_id*,
                           void (*)(const char*, const void*, size_t, void*),
                           void*, cl_int* err) {
  if (err) *err = CL_SUCCESS;
  return new _cl_context();
}
cl_int clReleaseContext(cl_context c) {
  delete c;
  return CL_SUCCESS;
}
cl_command_queue clCreateCommandQueue(cl_context, cl_device_id,
                                      cl_command_queue_properties props,
                                      cl_int* err) {
  if (err) *err = CL_SUCCESS;
  auto* q = new _cl_command_queue();
  q->profiling = (props & CL_QUEUE_PROFILING_ENABLE) != 0;
  return q;
}
cl_int clReleaseCommandQueue(cl_command_queue q) {
  delete q;
  return CL_SUCCESS;
}
cl_int clFlush(cl_command_queue) { return CL_SUCCESS; }
cl_int clFinish(cl_command_queue) { return CL_SUCCESS; }

// ---------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------
cl_mem clCreateBuffer(cl_context, cl_mem_flags flags, size_t size,
                      void* host_ptr, cl_int* err) {
  auto* m = new _cl_mem();
  m->size = size;
  m->data = (char*)calloc(1, size);
  if (host_ptr && (flags & (CL_MEM_COPY_HOST_PTR | CL_MEM_USE_HOST_PTR)))
    memcpy(m->data, host_ptr, size);
  if (err) *err = CL_SUCCESS;
  return m;
}

cl_mem clCreateImage2D(cl_context, cl_mem_flags flags,
                       const cl_image_format* fmt, size_t w, size_t h,
                       size_t row_pitch, void* host_ptr, cl_int* err) {
  if (fmt->image_channel_order != CL_RGBA ||
      fmt->image_channel_data_type != CL_UNSIGNED_INT8) {
    fprintf(stderr, "[cnnshim] unsupported image format %u/%u\n",
            fmt->image_channel_order, fmt->image_channel_data_type);
    if (err) *err = CL_IMAGE_FORMAT_NOT_SUPPORTED;
    return nullptr;
  }
  auto* m = new _cl_mem();
  m->is_image = true;
  m->size = w * h * 4;
  m->data = (char*)calloc(1, m->size);
  m->img = ShimImage{(int)w, (int)h, (const unsigned char*)m->data};
  if (host_ptr && (flags & (CL_MEM_COPY_HOST_PTR | CL_MEM_USE_HOST_PTR))) {
    size_t pitch = row_pitch ? row_pitch : w * 4;
    for (size_t y = 0; y < h; y++)
      memcpy(m->data + y * w * 4, (char*)host_ptr + y * pitch, w * 4);
  }
  if (err) *err = CL_SUCCESS;
  return m;
}

cl_int clReleaseMemObject(cl_mem m) {
  free(m->data);
  delete m;
  return CL_SUCCESS;
}

cl_int clEnqueueWriteBuffer(cl_command_queue, cl_mem m, cl_bool, size_t off,
                            size_t size, const void* src, cl_uint,
                            const cl_event*, cl_event* ev) {
  cl_ulong t0 = now_ns();
  memcpy(m->data + off, src, size);
  if (ev) {
    *ev = alloc_event();
    (*ev)->t0 = t0;
    (*ev)->t1 = now_ns();
  }
  return CL_SUCCESS;
}

cl_int clEnqueueReadBuffer(cl_command_queue, cl_mem m, cl_bool, size_t off,
                           size_t size, void* dst, cl_uint, const cl_event*,
                           cl_event* ev) {
  cl_ulong t0 = now_ns();
  memcpy(dst, m->data + off, size);
  if (ev) {
    *ev = alloc_event();
    (*ev)->t0 = t0;
    (*ev)->t1 = now_ns();
  }
  return CL_SUCCESS;
}

cl_int clEnqueueCopyBuffer(cl_command_queue, cl_mem src, cl_mem dst,
                           size_t soff, size_t doff, size_t size, cl_uint,
                           const cl_event*, cl_event* ev) {
  cl_ulong t0 = now_ns();
  memmove(dst->data + doff, src->data + soff, size);
  if (ev) {
    *ev = alloc_event();
    (*ev)->t0 = t0;
    (*ev)->t1 = now_ns();
  }
  return CL_SUCCESS;
}

cl_int clEnqueueWriteImage(cl_command_queue, cl_mem m, cl_bool,
                           const size_t* origin, const size_t* region,
                           size_t row_pitch, size_t, const void* src, cl_uint,
                           const cl_event*, cl_event* ev) {
  cl_ulong t0 = now_ns();
  size_t w = m->img.w;
  size_t pitch = row_pitch ? row_pitch : region[0] * 4;
  for (size_t y = 0; y < region[1]; y++) {
    memcpy(m->data + ((origin[1] + y) * w + origin[0]) * 4,
           (const char*)src + y * pitch, region[0] * 4);
  }
  if (ev) {
    *ev = alloc_event();
    (*ev)->t0 = t0;
    (*ev)->t1 = now_ns();
  }
  return CL_SUCCESS;
}

// ---------------------------------------------------------------------
// program build: .cl source -> C++ -> g++ -shared -> dlopen
// ---------------------------------------------------------------------
cl_program clCreateProgramWithSource(cl_context, cl_uint count,
                                     const char** strings,
                                     const size_t* lengths, cl_int* err) {
  auto* p = new _cl_program();
  for (cl_uint i = 0; i < count; i++) {
    if (lengths && lengths[i])
      p->source.append(strings[i], lengths[i]);
    else
      p->source.append(strings[i]);
  }
  if (err) *err = CL_SUCCESS;
  return p;
}

static std::string strip_line_comments(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size();) {
    if (s[i] == '/' && i + 1 < s.size() && s[i + 1] == '/') {
      while (i < s.size() && s[i] != '\n') i++;
    } else if (s[i] == '/' && i + 1 < s.size() && s[i + 1] == '*') {
      i += 2;
      while (i + 1 < s.size() && !(s[i] == '*' && s[i + 1] == '/')) i++;
      i += 2;
      out += ' ';
    } else {
      out += s[i++];
    }
  }
  return out;
}

static bool parse_kernel_sigs(const std::string& raw,
                              std::map<std::string, KernelSig>& sigs,
                              std::string& log) {
  std::string src = strip_line_comments(raw);
  size_t pos = 0;
  while ((pos = src.find("__kernel", pos)) != std::string::npos) {
    size_t open = src.find('(', pos);
    if (open == std::string::npos) break;
    // kernel name: last identifier before '('
    size_t ne = open;
    while (ne > pos && isspace((unsigned char)src[ne - 1])) ne--;
    size_t ns = ne;
    while (ns > pos && (isalnum((unsigned char)src[ns - 1]) || src[ns - 1] == '_')) ns--;
    std::string name = src.substr(ns, ne - ns);
    // matching close paren (no nested parens in these param lists)
    size_t close = src.find(')', open);
    if (close == std::string::npos) {
      log += "unbalanced parens after __kernel " + name + "\n";
      return false;
    }
    std::string params = src.substr(open + 1, close - open - 1);
    KernelSig sig;
    sig.name = name;
    size_t start = 0;
    int argi = 0;
    while (start <= params.size()) {
      size_t comma = params.find(',', start);
      std::string param = params.substr(
          start, comma == std::string::npos ? std::string::npos : comma - start);
      start = comma == std::string::npos ? params.size() + 1 : comma + 1;
      // normalize whitespace
      std::string t;
      for (char c : param) t += isspace((unsigned char)c) ? ' ' : c;
      while (!t.empty() && t.front() == ' ') t.erase(t.begin());
      while (!t.empty() && t.back() == ' ') t.pop_back();
      if (t.empty()) continue;
      char kind;
      std::string cast;
      char buf[128];
      if (t.find("image2d_t") != std::string::npos) {
        kind = 'I';
        snprintf(buf, sizeof(buf), "(image2d_t)argv[%d]", argi);
        cast = buf;
      } else if (t.find('*') != std::string::npos) {
        kind = t.find("__local") != std::string::npos ? 'L' : 'P';
        const char* base = t.find("uchar") != std::string::npos ? "uchar"
                           : t.find("uint") != std::string::npos ||
                                     t.find("unsigned int") != std::string::npos
                               ? "unsigned int"
                               : "float";
        snprintf(buf, sizeof(buf), "(%s*)argv[%d]", base, argi);
        cast = buf;
      } else {
        kind = 'S';
        const char* base = t.find("uint") != std::string::npos ? "unsigned int"
                           : t.find("float") != std::string::npos ? "float"
                                                                  : "int";
        snprintf(buf, sizeof(buf), "*(const %s*)argv[%d]", base, argi);
        cast = buf;
      }
      sig.kinds.push_back(kind);
      sig.casts.push_back(cast);
      argi++;
    }
    sigs[name] = sig;
    pos = close;
  }
  if (sigs.empty()) {
    log += "no __kernel functions found\n";
    return false;
  }
  return true;
}

cl_int clBuildProgram(cl_program p, cl_uint, const cl_device_id*,
                      const char* options, void (*)(cl_program, void*),
                      void*) {
  p->options = options ? options : "";
  if (!parse_kernel_sigs(p->source, p->sigs, p->build_log))
    return CL_BUILD_PROGRAM_FAILURE;
  p->uses_barrier = p->source.find("barrier(") != std::string::npos;

  // cache dir + key
  const char* cache_root = getenv("CNNSHIM_CACHE");
  std::string dir = cache_root ? cache_root : "/tmp/cnnshim_cache";
  mkdir(dir.c_str(), 0777);
  size_t h1 = std::hash<std::string>{}(p->source);
  size_t h2 = std::hash<std::string>{}(p->options);
  char key[64];
  snprintf(key, sizeof(key), "k_%016zx_%016zx_%zu", h1, h2, p->source.size());
  std::string base = dir + "/" + key;
  std::string so = base + ".so";

  if (access(so.c_str(), R_OK) != 0) {
    // generate the C++ translation unit: prelude + UNMODIFIED source +
    // one extern-C trampoline per kernel
    std::string gen;
    gen += "#include \"" CNNSHIM_COMPAT_DIR "/cl_compat.hpp\"\n";
    gen += "#line 1 \"kernel.cl\"\n";
    gen += p->source;
    gen += "\n\n// ---- generated trampolines ----\n";
    for (auto& kv : p->sigs) {
      const KernelSig& s = kv.second;
      gen += "extern \"C\" void __cnnshim_tramp_" + s.name + "(void** argv) {\n";
      gen += "  " + s.name + "(";
      for (size_t i = 0; i < s.casts.size(); i++) {
        if (i) gen += ", ";
        gen += s.casts[i];
      }
      gen += ");\n  (void)argv;\n}\n";
    }
    std::string cpp = base + ".cpp";
    FILE* f = fopen(cpp.c_str(), "w");
    if (!f) return CL_BUILD_PROGRAM_FAILURE;
    fwrite(gen.data(), 1, gen.size(), f);
    fclose(f);

    std::string cmd = "g++ -std=c++11 -O2 -shared -fPIC -Wno-narrowing -w ";
    // forward "-D FOO" / "-D FOO=1" build options verbatim
    cmd += p->options;
    cmd += " -o '" + so + "' '" + cpp + "' 2> '" + base + ".log'";
    int rc = system(cmd.c_str());
    if (rc != 0) {
      FILE* lf = fopen((base + ".log").c_str(), "r");
      if (lf) {
        char buf[4096];
        size_t n = fread(buf, 1, sizeof(buf) - 1, lf);
        buf[n] = 0;
        p->build_log += buf;
        fclose(lf);
      }
      fprintf(stderr, "[cnnshim] kernel build failed:\n%s\n",
              p->build_log.c_str());
      return CL_BUILD_PROGRAM_FAILURE;
    }
  }

  p->dl = dlopen(so.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!p->dl) {
    p->build_log += dlerror();
    return CL_BUILD_PROGRAM_FAILURE;
  }
  p->bind_fn = (void (*)(void*, void (*)(void*), void*))dlsym(
      p->dl, "__cnnshim_bind");
  if (!p->bind_fn) {
    p->build_log += "missing __cnnshim_bind";
    return CL_BUILD_PROGRAM_FAILURE;
  }
  return CL_SUCCESS;
}

cl_int clGetProgramBuildInfo(cl_program p, cl_device_id,
                             cl_program_build_info name, size_t sz, void* pv,
                             size_t* szret) {
  if (name == CL_PROGRAM_BUILD_LOG)
    return write_str(p->build_log.c_str(), sz, pv, szret);
  if (pv) memset(pv, 0, sz);
  if (szret) *szret = 0;
  return CL_SUCCESS;
}

cl_int clReleaseProgram(cl_program p) {
  if (p->dl) dlclose(p->dl);
  delete p;
  return CL_SUCCESS;
}

// ---------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------
cl_kernel clCreateKernel(cl_program p, const char* name, cl_int* err) {
  auto it = p->sigs.find(name);
  if (it == p->sigs.end()) {
    if (err) *err = CL_INVALID_KERNEL_NAME;
    return nullptr;
  }
  auto* k = new _cl_kernel();
  k->prog = p;
  k->name = name;
  k->tramp = (void (*)(void**))dlsym(p->dl,
                                     ("__cnnshim_tramp_" + k->name).c_str());
  if (!k->tramp) {
    if (err) *err = CL_INVALID_KERNEL_NAME;
    delete k;
    return nullptr;
  }
  k->args.resize(it->second.kinds.size());
  if (err) *err = CL_SUCCESS;
  return k;
}

cl_int clReleaseKernel(cl_kernel k) {
  delete k;
  return CL_SUCCESS;
}

cl_int clGetKernelWorkGroupInfo(cl_kernel, cl_device_id,
                                cl_kernel_work_group_info name, size_t sz,
                                void* p, size_t* szret) {
  switch (name) {
    case CL_KERNEL_WORK_GROUP_SIZE:
      return write_param<size_t>(256, sz, p, szret);
    case CL_KERNEL_PRIVATE_MEM_SIZE:
      return write_param<cl_ulong>(0, sz, p, szret);
    case CL_KERNEL_PREFERRED_WORK_GROUP_SIZE_MULTIPLE:
      return write_param<size_t>(1, sz, p, szret);
    case CL_KERNEL_LOCAL_MEM_SIZE:
      return write_param<cl_ulong>(0, sz, p, szret);
    default:
      if (p) memset(p, 0, sz);
      if (szret) *szret = sz;
      return CL_SUCCESS;
  }
}

cl_int clSetKernelArg(cl_kernel k, cl_uint idx, size_t size,
                      const void* value) {
  if (idx >= k->args.size()) return CL_INVALID_ARG_INDEX;
  KArg& a = k->args[idx];
  a.kind = k->prog->sigs[k->name].kinds[idx];
  if (!value) {  // __local allocation
    a.local_size = size;
    a.bytes.clear();
  } else {
    a.bytes.assign((const char*)value, (const char*)value + size);
    a.local_size = 0;
  }
  return CL_SUCCESS;
}

// ---------------------------------------------------------------------
// NDRange execution
// ---------------------------------------------------------------------

struct WIIds {  // layout mirror of cl_compat.hpp's __cnnshim_wi_ids
  size_t gid[3], lid[3], lsz[3], gsz[3];
};

struct BarrierRun {
  ucontext_t sched;
  std::vector<ucontext_t> wi;
  std::vector<std::vector<char>> stacks;
  std::vector<WIIds> ids;
  std::vector<char> done;
  size_t current = 0;
  void (*tramp)(void**) = nullptr;
  void** argv = nullptr;
  void (*bind_fn)(void*, void (*)(void*), void*) = nullptr;
};

static BarrierRun* g_run = nullptr;

static void barrier_cb(void* arg) {
  auto* r = (BarrierRun*)arg;
  swapcontext(&r->wi[r->current], &r->sched);
}

static void wi_entry() {
  BarrierRun* r = g_run;
  size_t i = r->current;
  r->tramp(r->argv);
  r->done[i] = 1;
  swapcontext(&r->wi[i], &r->sched);
}

cl_int clEnqueueNDRangeKernel(cl_command_queue, cl_kernel k, cl_uint work_dim,
                              const size_t*, const size_t* global,
                              const size_t* local, cl_uint, const cl_event*,
                              cl_event* ev) {
  cl_ulong t0 = now_ns();

  // CNNSHIM_TRACE=1: log every launch with its scalar args (both as float
  // and uint32 — the shim cannot know which) — the pipeline's means,
  // lengths and dims all travel as scalars, so this exposes the host
  // logic's actual numbers for parity debugging.
  if (getenv("CNNSHIM_TRACE")) {
    fprintf(stderr, "[trace] %s global=[%zu,%zu,%zu] local=[%zu,%zu,%zu]",
            k->name.c_str(), global ? global[0] : 0,
            work_dim > 1 && global ? global[1] : 1,
            work_dim > 2 && global ? global[2] : 1, local ? local[0] : 0,
            work_dim > 1 && local ? local[1] : 1,
            work_dim > 2 && local ? local[2] : 1);
    for (size_t i = 0; i < k->args.size(); i++) {
      const KArg& a = k->args[i];
      if (a.kind == 'S' && a.bytes.size() == 4) {
        float fv;
        unsigned uv;
        memcpy(&fv, a.bytes.data(), 4);
        memcpy(&uv, a.bytes.data(), 4);
        fprintf(stderr, " arg%zu=%g/%u", i, fv, uv);
      }
    }
    fprintf(stderr, "\n");
  }

  size_t g[3] = {1, 1, 1}, l[3] = {1, 1, 1};
  for (cl_uint d = 0; d < work_dim; d++) {
    g[d] = global[d];
    l[d] = local ? local[d] : global[d];
  }
  size_t groups[3] = {(g[0] + l[0] - 1) / l[0], (g[1] + l[1] - 1) / l[1],
                      (g[2] + l[2] - 1) / l[2]};
  size_t group_items = l[0] * l[1] * l[2];

  // resolve argv once; local buffers are per-group but groups run
  // sequentially, so one reused allocation per local arg suffices
  size_t nargs = k->args.size();
  std::vector<void*> argv(nargs);
  std::vector<std::vector<char>> local_bufs;
  for (size_t i = 0; i < nargs; i++) {
    KArg& a = k->args[i];
    switch (a.kind) {
      case 'P': {
        cl_mem m;
        memcpy(&m, a.bytes.data(), sizeof(m));
        argv[i] = m->data;
        break;
      }
      case 'I': {
        cl_mem m;
        memcpy(&m, a.bytes.data(), sizeof(m));
        argv[i] = (void*)&m->img;
        break;
      }
      case 'L': {
        local_bufs.emplace_back(a.local_size, 0);
        argv[i] = local_bufs.back().data();
        break;
      }
      default:
        argv[i] = a.bytes.data();
    }
  }
  // NB: local_bufs vector must not reallocate after taking .data()
  // (emplace order above guarantees stable addresses only if we reserve)
  // -> fix: re-resolve local pointers now that the vector is final
  {
    size_t li = 0;
    for (size_t i = 0; i < nargs; i++)
      if (k->args[i].kind == 'L') argv[i] = local_bufs[li++].data();
  }

  if (!k->prog->uses_barrier) {
    // fast path: plain loops, one shared ids block
    WIIds ids;
    memcpy(ids.lsz, l, sizeof(l));
    memcpy(ids.gsz, g, sizeof(g));
    k->prog->bind_fn(&ids, barrier_cb, nullptr);
    for (size_t gz = 0; gz < groups[2]; gz++)
      for (size_t gy = 0; gy < groups[1]; gy++)
        for (size_t gx = 0; gx < groups[0]; gx++)
          for (size_t lz = 0; lz < l[2]; lz++)
            for (size_t ly = 0; ly < l[1]; ly++)
              for (size_t lx = 0; lx < l[0]; lx++) {
                ids.lid[0] = lx; ids.lid[1] = ly; ids.lid[2] = lz;
                ids.gid[0] = gx * l[0] + lx;
                ids.gid[1] = gy * l[1] + ly;
                ids.gid[2] = gz * l[2] + lz;
                k->tramp(argv.data());
              }
  } else {
    // barrier path: each group's work-items are ucontext coroutines,
    // round-robin scheduled; barrier() swaps back here
    BarrierRun run;
    run.tramp = k->tramp;
    run.argv = argv.data();
    run.bind_fn = k->prog->bind_fn;
    run.wi.resize(group_items);
    run.stacks.resize(group_items);
    run.ids.resize(group_items);
    run.done.resize(group_items);
    for (size_t i = 0; i < group_items; i++)
      run.stacks[i].resize(256 << 10);
    g_run = &run;

    for (size_t gz = 0; gz < groups[2]; gz++)
      for (size_t gy = 0; gy < groups[1]; gy++)
        for (size_t gx = 0; gx < groups[0]; gx++) {
          // (re)create the coroutines for this group
          size_t i = 0;
          for (size_t lz = 0; lz < l[2]; lz++)
            for (size_t ly = 0; ly < l[1]; ly++)
              for (size_t lx = 0; lx < l[0]; lx++, i++) {
                WIIds& ids = run.ids[i];
                ids.lid[0] = lx; ids.lid[1] = ly; ids.lid[2] = lz;
                ids.gid[0] = gx * l[0] + lx;
                ids.gid[1] = gy * l[1] + ly;
                ids.gid[2] = gz * l[2] + lz;
                memcpy(ids.lsz, l, sizeof(l));
                memcpy(ids.gsz, g, sizeof(g));
                run.done[i] = 0;
                getcontext(&run.wi[i]);
                run.wi[i].uc_stack.ss_sp = run.stacks[i].data();
                run.wi[i].uc_stack.ss_size = run.stacks[i].size();
                run.wi[i].uc_link = nullptr;
                makecontext(&run.wi[i], wi_entry, 0);
              }
          // schedule until every item ran to completion
          bool all_done = false;
          while (!all_done) {
            all_done = true;
            for (size_t j = 0; j < group_items; j++) {
              if (run.done[j]) continue;
              all_done = false;
              run.current = j;
              run.bind_fn(&run.ids[j], barrier_cb, &run);
              swapcontext(&run.sched, &run.wi[j]);
            }
          }
        }
    g_run = nullptr;
  }

  if (ev) {
    *ev = alloc_event();
    (*ev)->t0 = t0;
    (*ev)->t1 = now_ns();
  }
  return CL_SUCCESS;
}

// ---------------------------------------------------------------------
// events
// ---------------------------------------------------------------------
cl_int clWaitForEvents(cl_uint, const cl_event*) { return CL_SUCCESS; }

cl_int clGetEventProfilingInfo(cl_event e, cl_profiling_info name, size_t sz,
                               void* p, size_t* szret) {
  switch (name) {
    case CL_PROFILING_COMMAND_QUEUED:
    case CL_PROFILING_COMMAND_SUBMIT:
    case CL_PROFILING_COMMAND_START:
      return write_param<cl_ulong>(e->t0, sz, p, szret);
    case CL_PROFILING_COMMAND_END:
      return write_param<cl_ulong>(e->t1, sz, p, szret);
    default:
      return write_param<cl_ulong>(0, sz, p, szret);
  }
}

}  // extern "C"
