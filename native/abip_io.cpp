// ABIP native IO: fast MPS parser.
//
// Host-side counterpart of the Python reader (abip/io/mps.py) for large
// benchmark suites -- the role MATLAB's mpsread plays in the reference
// pipeline (/root/reference/scripts/bench-lp/preprocess.m:15), implemented
// as a zero-dependency C++ shared library exposed through a C API consumed
// via ctypes (abip/io/native.py).
//
// Semantics match the Python reader: sections NAME/OBJSENSE/ROWS/COLUMNS/
// RHS/RANGES/BOUNDS/ENDATA, free format, standard RANGES rules, the
// negative-UP bound quirk, integer markers rejected.
//
// Build: make -C native   (produces libabip_io.so)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Triplet {
  int64_t row;
  int64_t col;
  double val;
};

struct MpsProblem {
  std::string name;
  bool maximize = false;
  double objcon = 0.0;  // -(RHS of objective row)
  std::vector<std::string> row_names, col_names;
  std::vector<double> c, row_lo, row_hi, lb, ub;
  std::vector<Triplet> triplets;
  // CSC, built on finalize
  std::vector<int64_t> Ap, Ai;
  std::vector<double> Ax;
  std::string error;
};

std::vector<std::string> tokenize(const std::string &line) {
  std::vector<std::string> out;
  std::istringstream ss(line);
  std::string tok;
  while (ss >> tok) out.push_back(tok);
  return out;
}

std::string upper(std::string s) {
  for (auto &ch : s) ch = std::toupper(static_cast<unsigned char>(ch));
  return s;
}

bool parse_double(const std::string &s, double *out) {
  try {
    size_t pos = 0;
    *out = std::stod(s, &pos);
    return pos == s.size();
  } catch (...) {
    return false;
  }
}

struct Parser {
  MpsProblem p;
  std::unordered_map<std::string, int64_t> row_idx, col_idx;
  std::unordered_map<std::string, char> row_sense;
  std::unordered_map<std::string, double> rhs, ranges;
  std::string obj_row;
  bool have_obj = false;
  bool in_integer = false;
  std::string section;
  int lineno = 0;

  bool fail(const std::string &msg) {
    p.error = "MPS parse error at line " + std::to_string(lineno) +
              " in section " + section + ": " + msg;
    return false;
  }

  bool handle_data_line(const std::vector<std::string> &t) {
    if (section == "ROWS") {
      if (t.size() < 2) return fail("ROWS line needs sense + name");
      const std::string sense = upper(t[0]);
      const std::string &rname = t[1];
      if (sense == "N") {
        if (!have_obj) { obj_row = rname; have_obj = true; }
      } else if (sense == "E" || sense == "L" || sense == "G") {
        row_idx[rname] = static_cast<int64_t>(p.row_names.size());
        p.row_names.push_back(rname);
        row_sense[rname] = sense[0];
      } else {
        return fail("unknown row sense " + sense);
      }
    } else if (section == "COLUMNS") {
      if (t.size() >= 3 && upper(t[1]) == "'MARKER'") {
        const std::string marker = upper(t[2]);
        if (marker.find("INTORG") != std::string::npos) in_integer = true;
        else if (marker.find("INTEND") != std::string::npos) in_integer = false;
        return true;
      }
      if (in_integer)
        return fail("integer variable '" + t[0] +
                    "': ABIP solves continuous LPs");
      const std::string &cname = t[0];
      auto it = col_idx.find(cname);
      int64_t j;
      if (it == col_idx.end()) {
        j = static_cast<int64_t>(p.col_names.size());
        col_idx[cname] = j;
        p.col_names.push_back(cname);
        p.c.push_back(0.0);
        p.lb.push_back(0.0);
        p.ub.push_back(kInf);
      } else {
        j = it->second;
      }
      for (size_t k = 1; k + 1 < t.size(); k += 2) {
        double val;
        if (!parse_double(t[k + 1], &val))
          return fail("bad numeric value '" + t[k + 1] + "'");
        if (have_obj && t[k] == obj_row) {
          p.c[j] += val;
        } else {
          auto rit = row_idx.find(t[k]);
          if (rit != row_idx.end())
            p.triplets.push_back({rit->second, j, val});
          // coefficients on unknown/free rows are dropped
        }
      }
    } else if (section == "RHS" || section == "RANGES") {
      auto &target = (section == "RHS") ? rhs : ranges;
      size_t start = (t.size() % 2 == 1) ? 1 : 0;  // optional set name
      for (size_t k = start; k + 1 < t.size(); k += 2) {
        double val;
        if (!parse_double(t[k + 1], &val))
          return fail("bad numeric value '" + t[k + 1] + "'");
        if (section == "RHS" && have_obj && t[k] == obj_row)
          p.objcon = -val;
        else if (row_idx.count(t[k]))
          target[t[k]] = val;
      }
    } else if (section == "BOUNDS") {
      // "BTYPE [SETNAME] COL [VAL]" -- the set name is optional, so a
      // 3-token line is ambiguous between "BTYPE SET COL" and
      // "BTYPE COL VAL".  Disambiguate by column-name membership
      // (COLUMNS precedes BOUNDS), mirroring the Python reader.
      if (t.size() < 2) return fail("BOUNDS line too short");
      const std::string btype = upper(t[0]);
      const bool needs_val =
          (btype == "LO" || btype == "UP" || btype == "FX");
      std::string cname;
      const std::string *vtok = nullptr;
      if (t.size() >= 4) {
        cname = t[2];
        vtok = &t[3];
      } else if (t.size() == 3) {
        if (needs_val) {
          if (col_idx.count(t[1])) {
            cname = t[1];  // no set name: "BTYPE COL VAL"
            vtok = &t[2];
          } else if (col_idx.count(t[2])) {
            return fail("bound type " + btype + " needs value for column '" +
                        t[2] + "'");
          } else {
            return fail("unknown column in BOUNDS line: '" + t[1] + "'/'" +
                        t[2] + "'");
          }
        } else {
          cname = col_idx.count(t[2]) ? t[2] : t[1];
        }
      } else {  // 2 tokens
        if (needs_val)
          return fail("bound type " + btype + " needs value");
        cname = t[1];
      }
      auto it = col_idx.find(cname);
      if (it == col_idx.end())
        return fail("unknown column in BOUNDS line: '" + cname + "'");
      const int64_t j = it->second;
      double val = 0.0;
      if (needs_val) {
        if (!parse_double(*vtok, &val))
          return fail("bad numeric value '" + *vtok + "'");
      }
      if (btype == "LO") p.lb[j] = val;
      else if (btype == "UP") {
        p.ub[j] = val;
        if (val < 0 && p.lb[j] == 0.0) p.lb[j] = -kInf;  // MPS quirk
      } else if (btype == "FX") { p.lb[j] = val; p.ub[j] = val; }
      else if (btype == "FR") { p.lb[j] = -kInf; p.ub[j] = kInf; }
      else if (btype == "MI") p.lb[j] = -kInf;
      else if (btype == "PL") p.ub[j] = kInf;
      else return fail("unsupported bound type " + btype);
    }
    return true;
  }

  bool parse(std::istream &in) {
    std::string line;
    bool pending_objsense = false;
    while (std::getline(in, line)) {
      ++lineno;
      if (line.empty()) continue;
      // strip trailing CR from DOS files
      if (line.back() == '\r') line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '*') continue;
      const bool header = !std::isspace(static_cast<unsigned char>(line[0]));
      auto t = tokenize(line);
      if (t.empty()) continue;
      if (header) {
        pending_objsense = false;
        section = upper(t[0]);
        if (section == "NAME") {
          p.name = t.size() > 1 ? t[1] : "";
        } else if (section == "OBJSENSE") {
          if (t.size() > 1) p.maximize = (upper(t[1]).rfind("MAX", 0) == 0);
          else pending_objsense = true;
        } else if (section == "ENDATA") {
          break;
        }
        continue;
      }
      if (pending_objsense) {
        p.maximize = (upper(t[0]).rfind("MAX", 0) == 0);
        pending_objsense = false;
        continue;
      }
      if (!handle_data_line(t)) return false;
    }
    if (!have_obj) {
      p.error = "MPS file has no objective (N) row";
      return false;
    }
    finalize();
    return true;
  }

  void finalize() {
    const int64_t m = static_cast<int64_t>(p.row_names.size());
    p.row_lo.assign(m, -kInf);
    p.row_hi.assign(m, kInf);
    for (int64_t i = 0; i < m; ++i) {
      const std::string &rname = p.row_names[i];
      const char s = row_sense[rname];
      const double rv = rhs.count(rname) ? rhs[rname] : 0.0;
      if (s == 'E') { p.row_lo[i] = rv; p.row_hi[i] = rv; }
      else if (s == 'L') p.row_hi[i] = rv;
      else p.row_lo[i] = rv;
      auto rg = ranges.find(rname);
      if (rg != ranges.end()) {
        const double rngv = rg->second;
        if (s == 'E') {
          if (rngv >= 0) p.row_hi[i] = rv + rngv;
          else p.row_lo[i] = rv + rngv;
        } else if (s == 'L') {
          p.row_lo[i] = rv - std::fabs(rngv);
        } else {
          p.row_hi[i] = rv + std::fabs(rngv);
        }
      }
    }
    // triplets -> CSC (counting sort by column; rows keep file order)
    const int64_t n = static_cast<int64_t>(p.col_names.size());
    const int64_t nnz = static_cast<int64_t>(p.triplets.size());
    p.Ap.assign(n + 1, 0);
    for (const auto &tr : p.triplets) ++p.Ap[tr.col + 1];
    for (int64_t j = 0; j < n; ++j) p.Ap[j + 1] += p.Ap[j];
    p.Ai.resize(nnz);
    p.Ax.resize(nnz);
    std::vector<int64_t> next(p.Ap.begin(), p.Ap.end() - 1);
    for (const auto &tr : p.triplets) {
      const int64_t k = next[tr.col]++;
      p.Ai[k] = tr.row;
      p.Ax[k] = tr.val;
    }
    p.triplets.clear();
  }
};

std::string join_names(const std::vector<std::string> &names) {
  std::string out;
  for (const auto &s : names) {
    out += s;
    out += '\n';
  }
  return out;
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr with *err_out filled.
void *abip_mps_parse(const char *path, char *err_out, int64_t err_len) {
  auto *parser = new Parser();
  std::ifstream in(path);
  if (!in) {
    std::snprintf(err_out, err_len, "cannot open %s", path);
    delete parser;
    return nullptr;
  }
  if (!parser->parse(in)) {
    std::snprintf(err_out, err_len, "%s", parser->p.error.c_str());
    delete parser;
    return nullptr;
  }
  return parser;
}

void abip_mps_free(void *h) { delete static_cast<Parser *>(h); }

void abip_mps_dims(void *h, int64_t *m, int64_t *n, int64_t *nnz,
                   int32_t *maximize, double *objcon) {
  auto &p = static_cast<Parser *>(h)->p;
  *m = static_cast<int64_t>(p.row_names.size());
  *n = static_cast<int64_t>(p.col_names.size());
  *nnz = static_cast<int64_t>(p.Ax.size());
  *maximize = p.maximize ? 1 : 0;
  *objcon = p.objcon;
}

// Caller allocates all arrays at the sizes from abip_mps_dims.
void abip_mps_data(void *h, double *c, double *row_lo, double *row_hi,
                   double *lb, double *ub, int64_t *Ap, int64_t *Ai,
                   double *Ax) {
  auto &p = static_cast<Parser *>(h)->p;
  const auto n = p.col_names.size();
  const auto m = p.row_names.size();
  std::memcpy(c, p.c.data(), n * sizeof(double));
  std::memcpy(row_lo, p.row_lo.data(), m * sizeof(double));
  std::memcpy(row_hi, p.row_hi.data(), m * sizeof(double));
  std::memcpy(lb, p.lb.data(), n * sizeof(double));
  std::memcpy(ub, p.ub.data(), n * sizeof(double));
  std::memcpy(Ap, p.Ap.data(), (n + 1) * sizeof(int64_t));
  std::memcpy(Ai, p.Ai.data(), p.Ai.size() * sizeof(int64_t));
  std::memcpy(Ax, p.Ax.data(), p.Ax.size() * sizeof(double));
}

// Name blobs: query length with buf=nullptr, then fill.
int64_t abip_mps_row_names(void *h, char *buf, int64_t len) {
  auto &p = static_cast<Parser *>(h)->p;
  const std::string blob = join_names(p.row_names);
  if (buf && len > 0)
    std::snprintf(buf, len, "%s", blob.c_str());
  return static_cast<int64_t>(blob.size()) + 1;
}

int64_t abip_mps_col_names(void *h, char *buf, int64_t len) {
  auto &p = static_cast<Parser *>(h)->p;
  const std::string blob = join_names(p.col_names);
  if (buf && len > 0)
    std::snprintf(buf, len, "%s", blob.c_str());
  return static_cast<int64_t>(blob.size()) + 1;
}

}  // extern "C"
