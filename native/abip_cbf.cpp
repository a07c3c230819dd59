// Native CBLIB Conic Benchmark Format (.cbf) parser.
//
// The C++ twin of abip/io/cbf.py:parse_cbf (same accepted grammar,
// same rejections), for large CBLIB files where Python tokenization
// dominates (measured 1.8x on a 3 MB / 110k-coordinate instance).
// Exposed through ctypes (abip/io/native.py) and validated against
// the Python parser on the committed cblib-mini suite
// (tests/test_native.py), including strict-rejection parity.
//
// Cone codes shared with the Python binding:
//   0=F  1=L+  2=L-  3=L=  4=Q  5=QR

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CbfProblem {
  int objsense = 0;  // 0 MIN, 1 MAX
  double obj_b = 0.0;
  int64_t n = 0, m = 0;
  std::vector<int32_t> var_codes, con_codes;
  std::vector<int64_t> var_dims, con_dims;
  std::vector<int64_t> obj_j;
  std::vector<double> obj_v;
  std::vector<int64_t> a_i, a_j;
  std::vector<double> a_v;
  std::vector<int64_t> b_i;
  std::vector<double> b_v;
  std::vector<int64_t> integers;
  std::string error;
};

const std::unordered_map<std::string, int32_t> kConeCodes = {
    {"F", 0}, {"L+", 1}, {"L-", 2}, {"L=", 3}, {"Q", 4}, {"QR", 5}};

bool is_unsupported_cone(const std::string &s) {
  return s == "EXP" || s == "EXP*" || s == "POW" || s == "POW*";
}

bool is_unsupported_section(const std::string &s) {
  return s == "PSDVAR" || s == "PSDCON" || s == "OBJFCOORD" ||
         s == "FCOORD" || s == "HCOORD" || s == "DCOORD" ||
         s == "OBJPSDVAR" || s == "CHANGE";
}


bool parse_i64(const std::string &s, int64_t *out) {
  std::istringstream ss(s);
  return static_cast<bool>(ss >> *out) && ss.eof();
}

bool parse_f64(const std::string &s, double *out) {
  std::istringstream ss(s);
  return static_cast<bool>(ss >> *out) && ss.eof();
}

struct Lines {
  std::vector<std::pair<int, std::string>> items;  // (lineno, stripped)
  size_t pos = 0;
};

std::string strip(const std::string &raw) {
  std::string s = raw.substr(0, raw.find('#'));
  size_t b = s.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(" \t\r\n");
  return s.substr(b, e - b + 1);
}

class Parser {
 public:
  CbfProblem prob;

  bool parse(const std::string &path) {
    std::ifstream f(path);
    if (!f) {
      prob.error = "cannot open " + path;
      return false;
    }
    std::string raw;
    int lineno = 0;
    while (std::getline(f, raw)) {
      ++lineno;
      std::string s = strip(raw);
      if (!s.empty()) lines_.items.emplace_back(lineno, s);
    }
    return run(path);
  }

 private:
  Lines lines_;
  std::string where_;

  bool fail(const std::string &msg, int lineno = 0) {
    std::ostringstream os;
    os << "CBF parse error at " << where_;
    if (lineno) os << ":" << lineno;
    os << ": " << msg;
    prob.error = os.str();
    return false;
  }

  bool next(int *lineno, std::string *s) {
    if (lines_.pos >= lines_.items.size())
      return fail("unexpected end of file");
    *lineno = lines_.items[lines_.pos].first;
    *s = lines_.items[lines_.pos].second;
    ++lines_.pos;
    return true;
  }

  bool read_cones(int64_t count, int64_t total, const char *section,
                  std::vector<int32_t> *codes, std::vector<int64_t> *dims) {
    int64_t acc = 0;
    for (int64_t k = 0; k < count; ++k) {
      int ln;
      std::string s;
      if (!next(&ln, &s)) return false;
      std::istringstream ss(s);
      std::string name;
      int64_t d = 0;
      if (!(ss >> name >> d) || !ss.eof())
        return fail(std::string("malformed ") + section + " cone line '" +
                        s + "'",
                    ln);
      if (is_unsupported_cone(name))
        return fail("cone '" + name +
                        "' is outside the supported set {F, L+, L-, L=, "
                        "Q, QR}",
                    ln);
      auto it = kConeCodes.find(name);
      if (it == kConeCodes.end())
        return fail("unknown cone '" + name + "'", ln);
      if (d < 1 || (name == "QR" && d < 3))
        return fail("bad dimension " + std::to_string(d) + " for cone " +
                        name,
                    ln);
      codes->push_back(it->second);
      dims->push_back(d);
      acc += d;
    }
    if (acc != total)
      return fail(std::string(section) + " cone dims sum to " +
                  std::to_string(acc) + ", expected " +
                  std::to_string(total));
    return true;
  }

  bool run(const std::string &path) {
    where_ = path;
    bool seen_ver = false, seen_var = false;
    int ln;
    std::string s;
    while (lines_.pos < lines_.items.size()) {
      if (!next(&ln, &s)) return false;
      const std::string kw = s;
      if (is_unsupported_section(kw))
        return fail("section '" + kw +
                        "' (semidefinite/parametric CBF) is not supported",
                    ln);
      if (kw == "VER") {
        if (!next(&ln, &s)) return false;
        int64_t v = 0;
        if (!parse_i64(s, &v) || v < 1 || v > 4)
          return fail("unsupported CBF version " + s, ln);
        seen_ver = true;
      } else if (kw == "OBJSENSE") {
        if (!next(&ln, &s)) return false;
        if (s == "MIN")
          prob.objsense = 0;
        else if (s == "MAX")
          prob.objsense = 1;
        else
          return fail("OBJSENSE must be MIN or MAX, got '" + s + "'", ln);
      } else if (kw == "VAR") {
        if (!next(&ln, &s)) return false;
        int64_t k = 0;
        std::istringstream ss(s);
        if (!(ss >> prob.n >> k) || !ss.eof())
          return fail("malformed VAR header '" + s + "'", ln);
        if (!read_cones(k, prob.n, "VAR", &prob.var_codes, &prob.var_dims))
          return false;
        seen_var = true;
      } else if (kw == "CON") {
        if (!next(&ln, &s)) return false;
        int64_t k = 0;
        std::istringstream ss(s);
        if (!(ss >> prob.m >> k) || !ss.eof())
          return fail("malformed CON header '" + s + "'", ln);
        if (!read_cones(k, prob.m, "CON", &prob.con_codes, &prob.con_dims))
          return false;
      } else if (kw == "INT") {
        if (!next(&ln, &s)) return false;
        int64_t cnt = 0;
        if (!parse_i64(s, &cnt))
          return fail("malformed INT count '" + s + "'", ln);
        for (int64_t i = 0; i < cnt; ++i) {
          if (!next(&ln, &s)) return false;
          int64_t j = 0;
          if (!parse_i64(s, &j))
            return fail("malformed INT entry '" + s + "'", ln);
          prob.integers.push_back(j);
        }
      } else if (kw == "OBJACOORD") {
        if (!next(&ln, &s)) return false;
        int64_t cnt = 0;
        if (!parse_i64(s, &cnt))
          return fail("malformed OBJACOORD count '" + s + "'", ln);
        for (int64_t i = 0; i < cnt; ++i) {
          if (!next(&ln, &s)) return false;
          std::istringstream ss(s);
          int64_t j;
          double v;
          if (!(ss >> j >> v) || !ss.eof())
            return fail("malformed OBJACOORD line '" + s + "'", ln);
          prob.obj_j.push_back(j);
          prob.obj_v.push_back(v);
        }
      } else if (kw == "OBJBCOORD") {
        if (!next(&ln, &s)) return false;
        if (!parse_f64(s, &prob.obj_b))
          return fail("malformed OBJBCOORD '" + s + "'", ln);
      } else if (kw == "ACOORD") {
        if (!next(&ln, &s)) return false;
        int64_t cnt = 0;
        if (!parse_i64(s, &cnt))
          return fail("malformed ACOORD count '" + s + "'", ln);
        prob.a_i.reserve(cnt);
        prob.a_j.reserve(cnt);
        prob.a_v.reserve(cnt);
        for (int64_t k2 = 0; k2 < cnt; ++k2) {
          if (!next(&ln, &s)) return false;
          std::istringstream ss(s);
          int64_t i, j;
          double v;
          if (!(ss >> i >> j >> v) || !ss.eof())
            return fail("malformed ACOORD line '" + s + "'", ln);
          prob.a_i.push_back(i);
          prob.a_j.push_back(j);
          prob.a_v.push_back(v);
        }
      } else if (kw == "BCOORD") {
        if (!next(&ln, &s)) return false;
        int64_t cnt = 0;
        if (!parse_i64(s, &cnt))
          return fail("malformed BCOORD count '" + s + "'", ln);
        for (int64_t k2 = 0; k2 < cnt; ++k2) {
          if (!next(&ln, &s)) return false;
          std::istringstream ss(s);
          int64_t i;
          double v;
          if (!(ss >> i >> v) || !ss.eof())
            return fail("malformed BCOORD line '" + s + "'", ln);
          prob.b_i.push_back(i);
          prob.b_v.push_back(v);
        }
      } else {
        return fail("unknown section keyword '" + kw + "'", ln);
      }
    }
    if (!seen_ver) return fail("missing VER section");
    if (!seen_var) return fail("missing VAR section");
    return true;
  }
};

}  // namespace

extern "C" {

void *abip_cbf_parse(const char *path, char *err_out, int64_t err_len) {
  auto *p = new Parser();
  if (!p->parse(path)) {
    std::strncpy(err_out, p->prob.error.c_str(), err_len - 1);
    err_out[err_len - 1] = '\0';
    delete p;
    return nullptr;
  }
  return p;
}

void abip_cbf_free(void *h) { delete static_cast<Parser *>(h); }

void abip_cbf_dims(void *h, int64_t *n, int64_t *m, int64_t *nvb,
                   int64_t *ncb, int64_t *nnz_a, int64_t *nnz_obj,
                   int64_t *nnz_b, int64_t *n_int, int64_t *objsense,
                   double *obj_b) {
  const auto &p = static_cast<Parser *>(h)->prob;
  *n = p.n;
  *m = p.m;
  *nvb = static_cast<int64_t>(p.var_codes.size());
  *ncb = static_cast<int64_t>(p.con_codes.size());
  *nnz_a = static_cast<int64_t>(p.a_v.size());
  *nnz_obj = static_cast<int64_t>(p.obj_v.size());
  *nnz_b = static_cast<int64_t>(p.b_v.size());
  *n_int = static_cast<int64_t>(p.integers.size());
  *objsense = p.objsense;
  *obj_b = p.obj_b;
}

void abip_cbf_blocks(void *h, int32_t *var_codes, int64_t *var_dims,
                     int32_t *con_codes, int64_t *con_dims) {
  const auto &p = static_cast<Parser *>(h)->prob;
  std::memcpy(var_codes, p.var_codes.data(),
              p.var_codes.size() * sizeof(int32_t));
  std::memcpy(var_dims, p.var_dims.data(),
              p.var_dims.size() * sizeof(int64_t));
  std::memcpy(con_codes, p.con_codes.data(),
              p.con_codes.size() * sizeof(int32_t));
  std::memcpy(con_dims, p.con_dims.data(),
              p.con_dims.size() * sizeof(int64_t));
}

void abip_cbf_data(void *h, int64_t *ai, int64_t *aj, double *av,
                   int64_t *oj, double *ov, int64_t *bi, double *bv,
                   int64_t *ii) {
  const auto &p = static_cast<Parser *>(h)->prob;
  std::memcpy(ai, p.a_i.data(), p.a_i.size() * sizeof(int64_t));
  std::memcpy(aj, p.a_j.data(), p.a_j.size() * sizeof(int64_t));
  std::memcpy(av, p.a_v.data(), p.a_v.size() * sizeof(double));
  std::memcpy(oj, p.obj_j.data(), p.obj_j.size() * sizeof(int64_t));
  std::memcpy(ov, p.obj_v.data(), p.obj_v.size() * sizeof(double));
  std::memcpy(bi, p.b_i.data(), p.b_i.size() * sizeof(int64_t));
  std::memcpy(bv, p.b_v.data(), p.b_v.size() * sizeof(double));
  std::memcpy(ii, p.integers.data(), p.integers.size() * sizeof(int64_t));
}

}  // extern "C"
