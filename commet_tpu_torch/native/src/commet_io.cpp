// Native IO of the PyTorch port (commet_tpu_torch): fasta/fastq(.gz)
// parsing into 2-bit codes with per-read class counts, the gather + pack of
// read batches into the device wire format of the CUDA kernels, and the
// per-read k-mer count of the partition cursor.
//
// Parsing and encoding are IO/byte-bound and belong in native code (the
// reference keeps them in C++ too: include/fasta_file.h,
// include/fastq_file.h). Semantics match the reference readers: fasta reads
// counted by '>' lines, sequence = concatenation of following non-empty
// lines; fastq read count = non-empty lines / 4, sequence = the line after
// each header; bytes outside ACGTacgt encode as 4 (invalid).
//
// Exposed as a C ABI consumed through ctypes (native/parser.py), which
// builds this file with g++ at first use.

#include <zlib.h>

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::vector<uint8_t> codes;    // concatenated 2-bit codes (4 = invalid)
  std::vector<int64_t> offsets;  // n_reads + 1
  std::vector<int32_t> lengths;  // n_reads
  std::vector<int64_t> class_counts;  // n_reads * 5 (A,C,G,T,other)
  int format = 0;                // 1 = fasta, 2 = fastq
  int gzipped = 0;
};

uint8_t g_code_lut[256];
struct LutInit {
  LutInit() {
    memset(g_code_lut, 4, sizeof(g_code_lut));
    g_code_lut[(unsigned)'A'] = g_code_lut[(unsigned)'a'] = 0;
    g_code_lut[(unsigned)'C'] = g_code_lut[(unsigned)'c'] = 1;
    g_code_lut[(unsigned)'G'] = g_code_lut[(unsigned)'g'] = 2;
    g_code_lut[(unsigned)'T'] = g_code_lut[(unsigned)'t'] = 3;
  }
} g_lut_init;

bool read_whole_file(const char* path, std::vector<char>& out) {
  // gzread transparently handles both plain and gzip files
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  const size_t chunk = 1 << 22;
  size_t size = 0;
  for (;;) {
    out.resize(size + chunk);
    int got = gzread(f, out.data() + size, chunk);
    if (got < 0) {
      gzclose(f);
      return false;
    }
    size += (size_t)got;
    if ((size_t)got < chunk) break;
  }
  out.resize(size);
  gzclose(f);
  return true;
}

void append_read(Parsed& p, const char* seq, size_t len) {
  int64_t counts[5] = {0, 0, 0, 0, 0};
  size_t base = p.codes.size();
  p.codes.resize(base + len);
  for (size_t i = 0; i < len; i++) {
    uint8_t c = g_code_lut[(unsigned char)seq[i]];
    p.codes[base + i] = c;
    counts[c]++;
  }
  p.lengths.push_back((int32_t)len);
  p.offsets.push_back((int64_t)(base + len));
  for (int i = 0; i < 5; i++) p.class_counts.push_back(counts[i]);
}

void parse_fasta(const std::vector<char>& raw, Parsed& p) {
  // a read per '>' line; sequence lines concatenated (fasta_file.h:62-68)
  const char* s = raw.data();
  const char* end = s + raw.size();
  std::string seq;
  bool in_read = false;
  const char* line = s;
  while (line < end) {
    const char* nl = (const char*)memchr(line, '\n', end - line);
    const char* eol = nl ? nl : end;
    if (line < eol && *line == '>') {
      if (in_read) append_read(p, seq.data(), seq.size());
      seq.clear();
      in_read = true;
    } else if (in_read && eol > line) {
      seq.append(line, eol - line);
    }
    line = nl ? nl + 1 : end;
  }
  if (in_read) append_read(p, seq.data(), seq.size());
}

void parse_fastq(const std::vector<char>& raw, Parsed& p) {
  // read count = non-empty lines / 4; seq = line right after each
  // (empty-line-skipped) header (fastq_file.h:60-67,154-173)
  const char* s = raw.data();
  const char* end = s + raw.size();
  std::vector<std::pair<const char*, const char*>> lines;
  const char* line = s;
  while (line < end) {
    const char* nl = (const char*)memchr(line, '\n', end - line);
    const char* eol = nl ? nl : end;
    lines.emplace_back(line, eol);
    line = nl ? nl + 1 : end;
  }
  size_t n_nonempty = 0;
  for (auto& ln : lines)
    if (ln.second > ln.first) n_nonempty++;
  size_t nb_reads = n_nonempty / 4;
  size_t i = 0, nl = lines.size();
  auto skip_empty = [&](size_t j) {
    while (j < nl && lines[j].second == lines[j].first) j++;
    return j;
  };
  for (size_t r = 0; r < nb_reads; r++) {
    i = skip_empty(i);
    if (i >= nl) break;
    i++;  // header
    const char* sq = i < nl ? lines[i].first : nullptr;
    size_t sl = i < nl ? (size_t)(lines[i].second - lines[i].first) : 0;
    i++;
    i = skip_empty(i);
    i++;  // plus
    i = skip_empty(i);
    i++;  // qual
    append_read(p, sq, sl);
  }
}

}  // namespace

extern "C" {

// Parse a read file. Returns an opaque handle (or null on failure).
void* cio_parse(const char* path) {
  std::vector<char> raw;
  if (!read_whole_file(path, raw)) return nullptr;
  Parsed* p = new Parsed;
  p->offsets.push_back(0);
  // format sniff on decompressed first byte (file_manager.h:117-157)
  char c = raw.empty() ? 0 : raw[0];
  if (c == '>') {
    p->format = 1;
    parse_fasta(raw, *p);
  } else if (c == '@') {
    p->format = 2;
    parse_fastq(raw, *p);
  } else {
    delete p;
    return nullptr;
  }
  // gz detection: re-check the on-disk first two bytes
  FILE* f = fopen(path, "rb");
  if (f) {
    unsigned char hdr[2] = {0, 0};
    size_t got = fread(hdr, 1, 2, f);
    fclose(f);
    p->gzipped = (got == 2 && hdr[0] == 0x1f && hdr[1] == 0x8b) ? 1 : 0;
  }
  return p;
}

int64_t cio_n_reads(void* h) { return ((Parsed*)h)->lengths.size(); }
int64_t cio_total_bases(void* h) { return (int64_t)((Parsed*)h)->codes.size(); }
int cio_format(void* h) { return ((Parsed*)h)->format; }
int cio_gzipped(void* h) { return ((Parsed*)h)->gzipped; }
const uint8_t* cio_codes(void* h) { return ((Parsed*)h)->codes.data(); }
const int64_t* cio_offsets(void* h) { return ((Parsed*)h)->offsets.data(); }
const int32_t* cio_lengths(void* h) { return ((Parsed*)h)->lengths.data(); }
const int64_t* cio_class_counts(void* h) {
  return ((Parsed*)h)->class_counts.data();
}
void cio_free(void* h) { delete (Parsed*)h; }

// Gather + transport-pack in one pass: rows idx[i] padded to lpad columns,
// emitted directly in the packed host->device wire format of the CUDA
// kernels (core/csrc/planes.cu, core/keys.py): 2-bit base codes LSB-first
// 16 per uint32 word, validity bits LSB-first 32 per word. Returns 1 if any
// read has an INTERNAL invalid base (i.e. the batch is not "clean": clean
// batches can ship per-read lengths instead of the validity plane).
// out_codes2 must hold n_idx * ceil(lpad/16) words, out_valid n_idx *
// ceil(lpad/32) words, out_lens n_idx int32.
int cio_gather_packed(const uint8_t* codes, const int64_t* offsets,
                      const int32_t* lengths, const int64_t* idx,
                      int64_t n_idx, int64_t lpad, uint32_t* out_codes2,
                      uint32_t* out_valid, int32_t* out_lens) {
  const int64_t w16 = (lpad + 15) / 16;
  const int64_t w32 = (lpad + 31) / 32;
  int dirty = 0;
  for (int64_t r = 0; r < n_idx; r++) {
    int64_t read = idx[r];
    const uint8_t* seq = codes + offsets[read];
    int64_t ln = lengths[read];
    if (ln > lpad) ln = lpad;
    uint32_t* c2 = out_codes2 + r * w16;
    uint32_t* vd = out_valid + r * w32;
    memset(c2, 0, (size_t)w16 * 4);
    memset(vd, 0, (size_t)w32 * 4);
    for (int64_t i = 0; i < ln; i++) {
      uint8_t c = seq[i];
      if (c < 4) {
        c2[i >> 4] |= ((uint32_t)c) << ((i & 15) * 2);
        vd[i >> 5] |= 1u << (i & 31);
      } else {
        dirty = 1;  // internal invalid (pad region never reaches here)
      }
    }
    out_lens[r] = (int32_t)ln;
  }
  return dirty;
}

// Count complete windows per read (partition cursor arithmetic,
// reference index_reads.h:55-58).
void cio_count_kmers(const uint8_t* codes, const int64_t* offsets,
                     const int32_t* lengths, const int64_t* idx,
                     int64_t n_idx, int k, int64_t* out) {
  for (int64_t r = 0; r < n_idx; r++) {
    int64_t read = idx[r];
    const uint8_t* seq = codes + offsets[read];
    int32_t len = lengths[read];
    int run = 0;
    int64_t n = 0;
    for (int32_t i = 0; i < len; i++) {
      if (seq[i] >= 4) {
        run = 0;
      } else if (++run >= k) {
        n++;
      }
    }
    out[r] = n;
  }
}

}  // extern "C"
