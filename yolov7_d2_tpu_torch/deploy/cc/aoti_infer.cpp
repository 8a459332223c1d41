// Serving client without Python: the port's counterpart of the JAX
// package's deploy/cc/pjrt_infer.cc (and of the reference's TensorRT C++
// demo). The program is an AOTInductor package of the exported model
// (python -m yolov7_d2_tpu_torch.export --fuse-postprocess --emit-package),
// loaded and run by libtorch's AOTIModelPackageLoader. YOLOX's tail is in
// the package, its NMS as a call of the op yolov7_d2_tpu_torch::nms_batched,
// which this process defines in C++ (nms_op.cpp): on the card the op
// launches the NMS kernel (csrc/nms.cu).
//
//   aoti_infer <model_aoti.pt2> <input.raw> <out_prefix>
//              [--device cuda|cpu] [--repeat N]
//   aoti_infer --op <boxes.raw> <scores.raw> B N thr max_out <out_prefix>
//              [--device cuda|cpu] [--repeat N]
//
// The first form reads a raw float32 NHWC batch of the shape that
// export_meta.json beside the package gives, runs the package once and
// writes output i as <out_prefix>.<i>.raw. The second runs the op alone on
// raw float32 boxes [B, N, 4] and scores [B, N] and writes keep_idx (int32)
// and keep_valid (bool) as <out_prefix>.0.raw and .1.raw. --repeat N then
// times N more calls after 3: a request by CUDA events on the card (the
// host clock on the CPU); the op's calls queued behind a sleep kernel, so
// that the time is the device's. The last line of stdout is one JSON
// object: the outputs' shapes and dtypes, the op's calls and launches over
// all runs, the runs, and the ms a call. It runs on the card unless
// --device cpu is given; a package or a request for another device than
// the one asked for, or a card that is missing, ends it with exit code 1.
// With no arguments it prints its usage and exits with 2. libtorch unpacks
// the package under $TMPDIR while it runs.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <functional>
#include <iterator>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#ifdef YOLO_CC_CUDA
#include <ATen/cuda/Sleep.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#endif

#include "nms_op.h"

namespace {

constexpr int kWarmup = 3;

int usage(const char* argv0) {
  std::fprintf(stderr,
               "usage: %s <model_aoti.pt2> <input.raw f32 NHWC> <out_prefix>"
               " [--device cuda|cpu] [--repeat N]\n"
               "       %s --op <boxes.raw> <scores.raw> B N thr max_out "
               "<out_prefix> [--device cuda|cpu] [--repeat N]\n"
               "  the input shape comes from export_meta.json beside the "
               "package\n",
               argv0, argv0);
  return 2;
}

[[noreturn]] void fail(const std::string& msg) {
  throw std::runtime_error(msg);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) fail("cannot open " + path);
  return std::string((std::istreambuf_iterator<char>(f)),
                     std::istreambuf_iterator<char>());
}

// A float32 tensor of `shape` from the raw file at `path`.
at::Tensor read_f32(const std::string& path, at::IntArrayRef shape) {
  const std::string raw = read_file(path);
  auto t = at::empty(shape, at::kFloat);
  const auto want = static_cast<size_t>(t.numel()) * sizeof(float);
  if (raw.size() != want) {
    fail(path + ": " + std::to_string(raw.size()) + " bytes, the shape " +
         c10::str(shape) + " takes " + std::to_string(want));
  }
  std::memcpy(t.data_ptr(), raw.data(), want);
  return t;
}

// "input_shape": [n, h, w, c] of export_meta.json beside the package.
std::vector<int64_t> input_shape(const std::string& package) {
  const auto slash = package.find_last_of('/');
  const std::string dir =
      slash == std::string::npos ? "." : package.substr(0, slash);
  const std::string meta = read_file(dir + "/export_meta.json");
  const auto key = meta.find("\"input_shape\"");
  const auto open = meta.find('[', key);
  const auto close = meta.find(']', open);
  if (key == std::string::npos || open == std::string::npos ||
      close == std::string::npos) {
    fail(dir + "/export_meta.json has no input_shape");
  }
  std::vector<int64_t> shape;
  std::stringstream items(meta.substr(open + 1, close - open - 1));
  for (std::string item; std::getline(items, item, ',');) {
    shape.push_back(std::stoll(item));
  }
  return shape;
}

void write_outputs(const std::vector<at::Tensor>& outs,
                   const std::string& prefix) {
  for (size_t i = 0; i < outs.size(); ++i) {
    const auto t = outs[i].to(at::kCPU).contiguous();
    const std::string path = prefix + "." + std::to_string(i) + ".raw";
    std::ofstream f(path, std::ios::binary);
    f.write(static_cast<const char*>(t.data_ptr()),
            static_cast<std::streamsize>(t.nbytes()));
    if (!f) fail("cannot write " + path);
  }
}

std::string dtype_name(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return "float32";
    case at::kBFloat16: return "bfloat16";
    case at::kHalf: return "float16";
    case at::kInt: return "int32";
    case at::kLong: return "int64";
    case at::kBool: return "bool";
    case at::kByte: return "uint8";
    default: return c10::toString(t);
  }
}

// Mean milliseconds of `repeat` calls of `fn` after kWarmup. On the card:
// CUDA events, the calls queued behind a sleep kernel where `queue` is set
// (the reading counts only if the event after the sleep is still pending
// once the last call is queued; else the sleep grows, as chip_smoke.py's
// kernel_ms does), `queued` then says whether it held. On the CPU: the
// host clock.
double time_calls(const std::function<void()>& fn, int repeat, bool cuda,
                  bool queue, bool* queued) {
  for (int i = 0; i < kWarmup; ++i) fn();
  *queued = false;
#ifdef YOLO_CC_CUDA
  if (cuda) {
    const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
    double ms = 0.0;
    for (const int64_t cycles : {2000000LL, 8000000LL, 32000000LL}) {
      cudaEvent_t start, end;
      if (cudaEventCreate(&start) != cudaSuccess ||
          cudaEventCreate(&end) != cudaSuccess) {
        fail("cudaEventCreate failed");
      }
      c10::cuda::device_synchronize();
      if (queue) at::cuda::sleep(cycles);
      cudaEventRecord(start, stream);
      for (int i = 0; i < repeat; ++i) fn();
      cudaEventRecord(end, stream);
      *queued = queue && cudaEventQuery(start) == cudaErrorNotReady;
      if (cudaEventSynchronize(end) != cudaSuccess) {
        fail("cudaEventSynchronize failed");
      }
      float elapsed = 0.0f;
      cudaEventElapsedTime(&elapsed, start, end);
      cudaEventDestroy(start);
      cudaEventDestroy(end);
      ms = elapsed / repeat;
      if (!queue || *queued) break;
    }
    return ms;
  }
#else
  (void)cuda;
  (void)queue;
#endif
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < repeat; ++i) fn();
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::milli>(t1 - t0).count() / repeat;
}

void sync(bool cuda) {
#ifdef YOLO_CC_CUDA
  if (cuda) c10::cuda::device_synchronize();
#else
  (void)cuda;
#endif
}

at::Device resolve_device(const std::string& name) {
  if (name == "cpu") return at::Device(at::kCPU);
  if (name != "cuda") fail("--device " + name + ": cuda or cpu");
#ifdef YOLO_CC_CUDA
  if (c10::cuda::device_count() == 0) fail("--device cuda: no CUDA device");
  return at::Device(at::kCUDA, 0);
#else
  fail("--device cuda: this client was built without CUDA");
#endif
}

int run(int argc, char** argv) {
  const bool op_mode = argc > 1 && std::string(argv[1]) == "--op";
  const int positional = op_mode ? 9 : 4;
  if (argc < positional) return usage(argv[0]);
  std::string device_name = "cuda";
  int repeat = 0;
  for (int i = positional; i < argc; ++i) {
    const std::string flag = argv[i];
    if (i + 1 >= argc) return usage(argv[0]);
    if (flag == "--device") {
      device_name = argv[++i];
    } else if (flag == "--repeat") {
      repeat = std::stoi(argv[++i]);
    } else {
      return usage(argv[0]);
    }
  }
  const at::Device device = resolve_device(device_name);
  const bool cuda = device.is_cuda();
  // float32 convolutions in float32, as the port's float32 checks run them
  // (cuDNN's default is TF32); bf16 programs are unaffected
  at::globalContext().setAllowTF32CuDNN(false);
  const c10::InferenceMode inference;

  std::vector<at::Tensor> outs;
  std::function<void()> call;
  std::string prefix;
  if (op_mode) {
    const int64_t b = std::stoll(argv[4]);
    const int64_t n = std::stoll(argv[5]);
    const double thr = std::stod(argv[6]);
    const int64_t max_out = std::stoll(argv[7]);
    prefix = argv[8];
    const auto boxes = read_f32(argv[2], {b, n, 4}).to(device);
    const auto scores = read_f32(argv[3], {b, n}).to(device);
    call = [boxes, scores, thr, max_out, &outs] {
      const auto [idx, valid] = yolo_cc::call_nms(boxes, scores, thr, max_out);
      outs = {idx, valid};
    };
  } else {
    prefix = argv[3];
    const std::string package = argv[1];
    const auto x = read_f32(argv[2], input_shape(package)).to(device);
    auto loader =
        std::make_shared<torch::inductor::AOTIModelPackageLoader>(package);
    const auto meta = loader->get_metadata();
    const auto where = meta.find("AOTI_DEVICE_KEY");
    if (where == meta.end() || where->second != device_name) {
      fail("the package runs on " +
           (where == meta.end() ? std::string("?") : where->second) +
           ", not on --device " + device_name);
    }
    call = [loader, x, &outs] { outs = loader->run({x}); };
  }

  yolo_cc::reset_nms_counts();
  call();
  sync(cuda);
  write_outputs(outs, prefix);
  int runs = 1;
  double ms = -1.0;
  bool queued = false;
  if (repeat > 0) {
    ms = time_calls(call, repeat, cuda, op_mode, &queued);
    runs += kWarmup + repeat;
  }

  std::ostringstream json;
  json << "{\"outputs\": [";
  for (size_t i = 0; i < outs.size(); ++i) {
    json << (i ? ", " : "") << "{\"shape\": [";
    for (int64_t d = 0; d < outs[i].dim(); ++d) {
      json << (d ? ", " : "") << outs[i].size(d);
    }
    json << "], \"dtype\": \"" << dtype_name(outs[i].scalar_type())
         << "\"}";
  }
  json << "], \"device\": \"" << device_name << "\", \"runs\": " << runs
       << ", \"op_calls\": " << yolo_cc::nms_calls()
       << ", \"op_launches\": " << yolo_cc::nms_launches() << ", \"ms\": ";
  if (ms < 0.0) {
    json << "null";
  } else {
    json.precision(6);
    json << std::fixed << ms;
  }
  json << ", \"repeat\": " << repeat << ", \"queued\": "
       << (queued ? "true" : "false") << "}";
  std::printf("%s\n", json.str().c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return run(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "aoti_infer: %s\n", e.what());
    return 1;
  }
}
