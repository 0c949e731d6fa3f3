// Native SPCAT fixed-width catalog tokenizer.
//
// Parses the CDMS/JPL .cat column layout (reference
// spectral_simulator/classes.py:154-178) into flat arrays, including the
// quantum-number quirks:
//   * a QN column containing any '+'/'-' entry remaps '' -> 0, '+' -> 1,
//     '-' -> 2 column-wide (reference functions.py:330-335, applied per
//     column at classes.py:180-214);
//   * alphabetic extended QNs decode as A0..Z9 / a0..z9 ->
//     100 + 10*letter + digit (reference functions.py:340-501);
//   * empty / undecodable fields -> 0.
//
// Only tokenization lives here; derived physics (eupper, sijmu, aij, glow)
// stays in the Python layer so the native and pure-Python loaders share it.
//
// A copy of native/spcat_parser.cpp. Built at first use by
// cha1_mcmc_tpu_torch/catalogs/native.py (g++ -O2 -shared -fPIC) into the
// port's build directory and loaded there through ctypes.

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// Trimmed view of text[start, start+len) clipped to the line length.
static std::string field(const char* line, long line_len, int start, int len) {
    if (start >= line_len) return std::string();
    int end = start + len;
    if (end > line_len) end = static_cast<int>(line_len);
    const char* b = line + start;
    const char* e = line + end;
    while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
    while (e > b && std::isspace(static_cast<unsigned char>(*(e - 1)))) --e;
    return std::string(b, e);
}

static double parse_double(const std::string& s) {
    return s.empty() ? 0.0 : std::strtod(s.c_str(), nullptr);
}

static long parse_long(const std::string& s) {
    return s.empty() ? 0 : std::strtol(s.c_str(), nullptr, 10);
}

// Decode one QN field. has_pm: the owning column contains a parity label.
static long decode_qn(const std::string& s, bool has_pm) {
    if (has_pm) {
        if (s.empty()) return 0;
        if (s == "+") return 1;
        if (s == "-") return 2;
    }
    if (s.empty()) return 0;
    char* endp = nullptr;
    long v = std::strtol(s.c_str(), &endp, 10);
    if (endp && *endp == '\0' && endp != s.c_str()) return v;
    char c = s[0];
    int letter = -1;
    if (c >= 'A' && c <= 'Z') letter = c - 'A';
    else if (c >= 'a' && c <= 'z') letter = c - 'a';
    if (letter < 0) return 0;
    long base = 100 + 10L * letter;
    if (s.size() > 1 && std::isdigit(static_cast<unsigned char>(s[1])))
        return base + (s[1] - '0');
    return base;
}

static bool is_blank(const char* b, const char* e) {
    for (const char* p = b; p < e; ++p)
        if (!std::isspace(static_cast<unsigned char>(*p))) return false;
    return true;
}

}  // namespace

extern "C" {

// Parse `text` (length `length`) into the output arrays (capacity
// `max_lines`; qn is max_lines x 12 row-major). Returns the number of
// parsed lines, or -1 on overflow.
long spcat_parse(const char* text, long length, long max_lines,
                 double* frequency, double* error_out, double* logint,
                 long* dof, double* elower, long* gup, long* tag,
                 long* qnformat, long* qn) {
    // Pass 1: collect line extents, skipping blank lines (the Python loader
    // drops them the same way).
    long n = 0;
    const char* p = text;
    const char* end = text + length;

    // Temporary storage of raw QN fields for the column-wise parity rule.
    // To avoid an O(lines*12) std::string matrix we do two sweeps over the
    // text: sweep A detects parity columns, sweep B decodes everything.
    bool col_has_pm[12] = {false};

    for (const char* q = p; q < end;) {
        const char* nl = static_cast<const char*>(memchr(q, '\n', end - q));
        const char* line_end = nl ? nl : end;
        if (!is_blank(q, line_end)) {
            long line_len = line_end - q;
            for (int col = 0; col < 12; ++col) {
                // qn12 runs to end of line (reference classes.py:178)
                long w = (col == 11) ? line_len - 77 : 2;
                std::string s = field(q, line_len, 55 + 2 * col, w);
                if (s == "+" || s == "-") col_has_pm[col] = true;
            }
        }
        q = nl ? nl + 1 : end;
    }

    for (const char* q = p; q < end;) {
        const char* nl = static_cast<const char*>(memchr(q, '\n', end - q));
        const char* line_end = nl ? nl : end;
        if (!is_blank(q, line_end)) {
            if (n >= max_lines) return -1;
            long line_len = line_end - q;
            frequency[n] = parse_double(field(q, line_len, 0, 13));
            error_out[n] = parse_double(field(q, line_len, 13, 8));
            logint[n] = parse_double(field(q, line_len, 21, 8));
            dof[n] = parse_long(field(q, line_len, 29, 2));
            elower[n] = parse_double(field(q, line_len, 31, 10));
            {
                std::string g = field(q, line_len, 41, 3);
                char* endp = nullptr;
                long v = g.empty() ? 0 : std::strtol(g.c_str(), &endp, 10);
                if (!g.empty() && endp && *endp == '\0') gup[n] = v;
                else gup[n] = decode_qn(g, false);
            }
            tag[n] = parse_long(field(q, line_len, 44, 7));
            qnformat[n] = parse_long(field(q, line_len, 51, 4));
            for (int col = 0; col < 12; ++col) {
                long w = (col == 11) ? line_len - 77 : 2;  // qn12: to EOL
                qn[n * 12 + col] =
                    decode_qn(field(q, line_len, 55 + 2 * col, w), col_has_pm[col]);
            }
            ++n;
        }
        q = nl ? nl + 1 : end;
    }
    return n;
}

}  // extern "C"
