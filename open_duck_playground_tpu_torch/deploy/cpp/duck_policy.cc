// Native policy runtime for deployment (replaces the reference's
// onnxruntime dependency for the robot-side control loop).
//
// Loads the ONNX files produced by export/export.py -- a fixed op set
// (Sub, Div, MatMul, Add, Sigmoid, Mul, Slice, Tanh) over float32 tensors --
// via a self-contained protobuf wire-format reader, and evaluates the
// graph with a simple interpreter. No external dependencies; built as a
// shared library consumed through ctypes (deploy/policy_runtime.py).
//
// C ABI:
//   void* duck_policy_load(const char* path);      // NULL on failure
//   int   duck_policy_obs_size(void* h);
//   int   duck_policy_act_size(void* h);
//   int   duck_policy_infer(void* h, const float* obs, int obs_n,
//                           float* out, int out_n);  // 0 on success
//   void  duck_policy_free(void* h);

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Tensor {
  std::vector<int64_t> dims;
  std::vector<float> f32;
  std::vector<int64_t> i64;
  size_t numel() const {
    size_t n = 1;
    for (auto d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

struct Node {
  std::string op;
  std::vector<std::string> inputs;
  std::vector<std::string> outputs;
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool next(uint32_t* field, uint32_t* wire) {
    if (p >= end) return false;
    uint64_t key = varint();
    *field = static_cast<uint32_t>(key >> 3);
    *wire = static_cast<uint32_t>(key & 7);
    return ok;
  }

  Reader sub() {
    uint64_t len = varint();
    Reader r{p, p + len};
    p += len;
    if (p > end) {
      ok = false;
      r.end = r.p;
    }
    return r;
  }

  void skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: { uint64_t len = varint(); p += len; break; }
      case 5: p += 4; break;
      default: ok = false;
    }
  }

  std::string str() {
    uint64_t len = varint();
    std::string s(reinterpret_cast<const char*>(p), len);
    p += len;
    return s;
  }
};

// onnx TensorProto: dims=1, data_type=2, name=8, raw_data=9
Tensor parse_tensor(Reader r, std::string* name) {
  Tensor t;
  int32_t dtype = 1;
  uint32_t field, wire;
  while (r.next(&field, &wire)) {
    if (field == 1 && wire == 0) {
      t.dims.push_back(static_cast<int64_t>(r.varint()));
    } else if (field == 2 && wire == 0) {
      dtype = static_cast<int32_t>(r.varint());
    } else if (field == 8 && wire == 2) {
      *name = r.str();
    } else if (field == 9 && wire == 2) {
      uint64_t len = r.varint();
      if (dtype == 1) {  // FLOAT
        t.f32.resize(len / 4);
        std::memcpy(t.f32.data(), r.p, len);
      } else if (dtype == 7) {  // INT64
        t.i64.resize(len / 8);
        std::memcpy(t.i64.data(), r.p, len);
      }
      r.p += len;
    } else {
      r.skip(wire);
    }
  }
  return t;
}

// onnx NodeProto: input=1, output=2, name=3, op_type=4
Node parse_node(Reader r) {
  Node n;
  uint32_t field, wire;
  while (r.next(&field, &wire)) {
    if (field == 1 && wire == 2) n.inputs.push_back(r.str());
    else if (field == 2 && wire == 2) n.outputs.push_back(r.str());
    else if (field == 4 && wire == 2) n.op = r.str();
    else r.skip(wire);
  }
  return n;
}

struct Policy {
  std::vector<Node> nodes;
  std::map<std::string, Tensor> init;
  std::string input_name = "obs";
  std::string output_name = "continuous_actions";
  int obs_size = 0;
  int act_size = 0;
};

std::string value_info_name(Reader r) {
  uint32_t field, wire;
  while (r.next(&field, &wire)) {
    if (field == 1 && wire == 2) return r.str();
    r.skip(wire);
  }
  return "";
}

Policy* load(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
  auto policy = std::make_unique<Policy>();
  Reader model{buf.data(), buf.data() + buf.size()};
  uint32_t field, wire;
  while (model.next(&field, &wire)) {
    if (field == 7 && wire == 2) {  // graph
      Reader g = model.sub();
      uint32_t gf, gw;
      while (g.next(&gf, &gw)) {
        if (gf == 1 && gw == 2) {
          policy->nodes.push_back(parse_node(g.sub()));
        } else if (gf == 5 && gw == 2) {
          std::string name;
          Tensor t = parse_tensor(g.sub(), &name);
          policy->init[name] = std::move(t);
        } else if (gf == 11 && gw == 2) {
          policy->input_name = value_info_name(g.sub());
        } else if (gf == 12 && gw == 2) {
          policy->output_name = value_info_name(g.sub());
        } else {
          g.skip(gw);
        }
      }
    } else {
      model.skip(wire);
    }
  }
  // infer sizes from the normalization mean and the slice end
  auto it = policy->init.find("obs_mean");
  if (it != policy->init.end()) policy->obs_size = static_cast<int>(it->second.numel());
  auto se = policy->init.find("slice_ends");
  if (se != policy->init.end() && !se->second.i64.empty())
    policy->act_size = static_cast<int>(se->second.i64[0]);
  return policy.release();
}

int infer(Policy* p, const float* obs, int obs_n, float* out, int out_n) {
  std::map<std::string, std::vector<float>> env;
  env[p->input_name] = std::vector<float>(obs, obs + obs_n);
  for (const auto& kv : p->init) {
    if (!kv.second.f32.empty()) env[kv.first] = kv.second.f32;
  }
  for (const auto& n : p->nodes) {
    if (n.op == "Sub" || n.op == "Div" || n.op == "Add" || n.op == "Mul") {
      const auto& a = env[n.inputs[0]];
      const auto& b = env[n.inputs[1]];
      std::vector<float> o(std::max(a.size(), b.size()));
      for (size_t i = 0; i < o.size(); ++i) {
        float x = a[i % a.size()], y = b[i % b.size()];
        o[i] = n.op == "Sub" ? x - y : n.op == "Div" ? x / y
             : n.op == "Add" ? x + y : x * y;
      }
      env[n.outputs[0]] = std::move(o);
    } else if (n.op == "MatMul") {
      const auto& x = env[n.inputs[0]];           // (1, K)
      const auto& w = env[n.inputs[1]];           // (K, N)
      const auto& wt = p->init.at(n.inputs[1]);
      int K = static_cast<int>(wt.dims[0]);
      int N = static_cast<int>(wt.dims[1]);
      std::vector<float> o(N, 0.f);
      for (int k = 0; k < K; ++k) {
        float xv = x[k];
        const float* wrow = &w[k * N];
        for (int j = 0; j < N; ++j) o[j] += xv * wrow[j];
      }
      env[n.outputs[0]] = std::move(o);
    } else if (n.op == "Sigmoid") {
      auto o = env[n.inputs[0]];
      for (auto& v : o) v = 1.f / (1.f + std::exp(-v));
      env[n.outputs[0]] = std::move(o);
    } else if (n.op == "Tanh") {
      auto o = env[n.inputs[0]];
      for (auto& v : o) v = std::tanh(v);
      env[n.outputs[0]] = std::move(o);
    } else if (n.op == "Slice") {
      const auto& x = env[n.inputs[0]];
      const auto& starts = p->init.at(n.inputs[1]).i64;
      const auto& ends = p->init.at(n.inputs[2]).i64;
      std::vector<float> o(x.begin() + starts[0], x.begin() + ends[0]);
      env[n.outputs[0]] = std::move(o);
    } else {
      return 1;  // unsupported op
    }
  }
  const auto& result = env[p->output_name];
  if (static_cast<int>(result.size()) != out_n) return 2;
  std::memcpy(out, result.data(), sizeof(float) * out_n);
  return 0;
}

}  // namespace

extern "C" {

void* duck_policy_load(const char* path) { return load(path); }

int duck_policy_obs_size(void* h) { return static_cast<Policy*>(h)->obs_size; }

int duck_policy_act_size(void* h) { return static_cast<Policy*>(h)->act_size; }

int duck_policy_infer(void* h, const float* obs, int obs_n, float* out, int out_n) {
  return infer(static_cast<Policy*>(h), obs, obs_n, out, out_n);
}

void duck_policy_free(void* h) { delete static_cast<Policy*>(h); }

}  // extern "C"
