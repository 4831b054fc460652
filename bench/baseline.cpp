// CPU baseline comparator: an independent C++ implementation of the
// reference's algorithm (AlgoLab/shark) used by bench.py as the
// "16-thread CPU shark" stand-in that the device pipeline is compared with.
//
// Algorithm semantics follow the reference behavior documented in SURVEY.md:
//   - canonical k-mer = min(packed, revcomp) over all-ACGT windows
//     (reference kmer_utils.hpp:57-79, KmerBuilder.hpp:52-67)
//   - XXH64(8-byte kmer, seed 0) % bf_size addresses a Bloom bit-vector
//     (reference kmer_utils.hpp:81-83, bloomfilter.h:88)
//   - per Bloom position an ascending unique gene list (bloomfilter.h:61-75)
//   - per read: cov += min(k, pos - last) coverage scoring with the
//     first-probe pos+1 quirk, lexicographic (cov, hits) argmax with ties,
//     emit iff cov >= c*len (reference ReadAnalyzer.hpp:39-109)
//
// The index layout here is bit-vector + per-word rank + CSR, which is
// faster than the reference's sdsl rank+select walk — a conservative
// (stronger) baseline. Build: g++ -O3 -march=native -std=c++17 -pthread
//
// Usage: baseline <fasta> <fastq> <k> <c> <bf_bits> <threads> [fastq2] [minq]
//   fastq2: optional mate file — pairs fuse as seq1+'N'+seq2 and classify
//           jointly (reference FastqSplitter.hpp:63)
//   minq:   optional quality cut — bases with qual < minq+33 mask invalid
//           over the fused qual = qual1+'\33'+qual2 (FastqSplitter.hpp:84-113)
// Prints: n_reads, n_associations, build_s, classify_s, reads_per_sec

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <fstream>
#include <map>
#include <string>
#include <thread>
#include <vector>

static constexpr uint64_t P1 = 11400714785074694791ULL;
static constexpr uint64_t P2 = 14029467366897019727ULL;
static constexpr uint64_t P3 = 1609587929392839161ULL;
static constexpr uint64_t P4 = 9650029242287828579ULL;
static constexpr uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t xxh64_8(uint64_t x) {
  uint64_t h = P5 + 8;
  uint64_t k1 = rotl64(x * P2, 31) * P1;
  h ^= k1;
  h = rotl64(h, 27) * P1 + P4;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

static int8_t CODE[256];
static void init_code() {
  memset(CODE, -1, sizeof(CODE));
  CODE[(int)'A'] = CODE[(int)'a'] = 0;
  CODE[(int)'C'] = CODE[(int)'c'] = 1;
  CODE[(int)'G'] = CODE[(int)'g'] = 2;
  CODE[(int)'T'] = CODE[(int)'t'] = 3;
}

// Enumerate canonical k-mers of all valid windows, calling f(canon, end_pos).
template <typename F>
static void scan_kmers(const std::string& seq, int k, F&& f) {
  const size_t n = seq.size();
  if ((int)n < k) return;
  uint64_t fwd = 0, rc = 0;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  const int top = 2 * (k - 1);
  int run = 0;  // consecutive valid bases ending here
  for (size_t i = 0; i < n; i++) {
    int8_t c = CODE[(uint8_t)seq[i]];
    if (c < 0) {
      run = 0;
      continue;
    }
    fwd = ((fwd << 2) | (uint64_t)c) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
    if (++run >= k) f(fwd < rc ? fwd : rc, i);
  }
}

struct Index {
  uint64_t size_bits;
  std::vector<uint32_t> words;      // bit-vector
  std::vector<uint32_t> word_rank;  // exclusive popcount prefix
  std::vector<int32_t> offsets;     // CSR
  std::vector<uint16_t> genes;
  int n_genes = 0;

  inline bool probe(uint64_t kmer, const uint16_t** beg,
                    const uint16_t** end) const {
    uint64_t p = xxh64_8(kmer) % size_bits;
    uint32_t w = words[p >> 5];
    uint32_t bit = (uint32_t)(p & 31);
    if (!((w >> bit) & 1)) return false;
    uint32_t r = word_rank[p >> 5] + __builtin_popcount(w & ((1u << bit) - 1));
    *beg = genes.data() + offsets[r];
    *end = genes.data() + offsets[r + 1];
    return true;
  }
};

static void build_index(const char* fasta_path, int k, uint64_t size_bits,
                        Index& ix) {
  ix.size_bits = size_bits;
  std::ifstream f(fasta_path);
  std::string line, seq;
  std::vector<std::pair<uint64_t, uint16_t>> pairs;  // (bf position, gene)
  int gene = -1;
  std::vector<uint64_t> pos;
  auto flush = [&]() {
    if (gene < 0) return;
    pos.clear();
    scan_kmers(seq, k, [&](uint64_t canon, size_t) {
      pos.push_back(xxh64_8(canon) % size_bits);
    });
    std::sort(pos.begin(), pos.end());
    pos.erase(std::unique(pos.begin(), pos.end()), pos.end());
    for (uint64_t p : pos) pairs.emplace_back(p, (uint16_t)gene);
    seq.clear();
  };
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
      flush();
      gene++;
    } else if (gene >= 0) {
      seq += line;
    }
  }
  flush();
  ix.n_genes = gene + 1;

  std::stable_sort(pairs.begin(), pairs.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  uint64_t n_words = size_bits / 32;
  ix.words.assign(n_words, 0);
  for (auto& pg : pairs) ix.words[pg.first >> 5] |= 1u << (pg.first & 31);
  ix.word_rank.assign(n_words, 0);
  uint64_t acc = 0;
  for (uint64_t w = 0; w < n_words; w++) {
    ix.word_rank[w] = (uint32_t)acc;
    acc += __builtin_popcount(ix.words[w]);
  }
  ix.offsets.reserve(acc + 1);
  ix.offsets.push_back(0);
  ix.genes.reserve(pairs.size());
  uint64_t prev = ~0ULL;
  for (auto& pg : pairs) {
    if (pg.first != prev && prev != ~0ULL) ix.offsets.push_back((int32_t)ix.genes.size());
    ix.genes.push_back(pg.second);
    prev = pg.first;
  }
  if (!pairs.empty()) ix.offsets.push_back((int32_t)ix.genes.size());
}

struct GeneState {
  int cov = 0, hits = 0, last = 0;
};

// Classify one read; returns number of associations emitted. When `out`
// is non-null, also appends the winning gene ids (ascending — std::map
// iteration order) so a full-sample association dump can be compared
// against the device pipeline's ssv, not just the counts.
static int classify(const Index& ix, const std::string& seq, int k, double c,
                    std::vector<uint16_t>* out = nullptr) {
  int len = 0;
  for (char ch : seq) len += CODE[(uint8_t)ch] >= 0;
  if (len < k) return 0;
  std::map<int, GeneState> st;  // ordered, like the reference std::map
  bool first = true;
  scan_kmers(seq, k, [&](uint64_t canon, size_t e) {
    const uint16_t *beg, *end;
    if (!ix.probe(canon, &beg, &end)) { return; }
    int pos_eff = first ? (int)e + 1 : (int)e;
    for (const uint16_t* g = beg; g != end; ++g) {
      GeneState& s = st[*g];
      s.cov += std::min(k, pos_eff - s.last);
      s.hits = first ? 1 : s.hits + 1;
      s.last = (int)e;
    }
    first = false;
  });
  int best_cov = 0, best_hits = 0, n_win = 0;
  for (auto& kv : st) {
    if (kv.second.cov > best_cov ||
        (kv.second.cov == best_cov && kv.second.hits > best_hits)) {
      best_cov = kv.second.cov;
      best_hits = kv.second.hits;
      n_win = 1;
    } else if (kv.second.cov == best_cov && kv.second.hits == best_hits &&
               best_cov > 0) {
      n_win++;
    }
  }
  if ((double)best_cov >= c * (double)len) {
    if (out) {
      for (auto& kv : st)
        if (kv.second.cov == best_cov && kv.second.hits == best_hits)
          out->push_back((uint16_t)kv.first);
    }
    return n_win;
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s <fasta> <fastq> <k> <c> <bf_bits> <threads>\n", argv[0]);
    return 1;
  }
  init_code();
  const char* fasta = argv[1];
  const char* fastq = argv[2];
  int k = atoi(argv[3]);
  double c = atof(argv[4]);
  uint64_t bf_bits = strtoull(argv[5], nullptr, 10);
  int threads = atoi(argv[6]);
  const char* fastq2 = (argc > 7 && argv[7][0]) ? argv[7] : nullptr;
  int minq = argc > 8 ? atoi(argv[8]) : 0;
  // optional 9th arg: write every (read_index, gene_id) association to
  // this path, sorted — the full-sample exactness comparator for the
  // transcriptome bench (bench/transcriptome_bench.py)
  const char* dump = (argc > 9 && argv[9][0]) ? argv[9] : nullptr;

  auto t0 = std::chrono::steady_clock::now();
  Index ix;
  build_index(fasta, k, bf_bits, ix);
  auto t1 = std::chrono::steady_clock::now();

  // Load all reads up front, fusing pairs and applying quality masking, so
  // classify timing is pure compute (favors the baseline: the device side is
  // timed end-to-end including host parse + encode + mask).
  auto load = [](const char* path, std::vector<std::string>& seqs,
                 std::vector<std::string>& quals) {
    std::ifstream f(path);
    std::string line;
    int ln = 0;
    while (std::getline(f, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      if (ln % 4 == 1) seqs.push_back(line);
      if (ln % 4 == 3) quals.push_back(line);
      ln++;
    }
  };
  std::vector<std::string> reads, quals;
  load(fastq, reads, quals);
  if (fastq2) {
    std::vector<std::string> r2, q2;
    load(fastq2, r2, q2);
    size_t n = std::min(reads.size(), r2.size());
    reads.resize(n);
    quals.resize(n);
    for (size_t i = 0; i < n; i++) {
      reads[i] += "N" + r2[i];
      quals[i] += "\33" + q2[i];
    }
  }
  if (minq > 0) {
    const char cut = (char)(minq + 33);
    for (size_t i = 0; i < reads.size(); i++)
      for (size_t j = 0; j < quals[i].size() && j < reads[i].size(); j++)
        if (quals[i][j] < cut) reads[i][j] -= 64;  // FastqSplitter.hpp:106
  }

  auto t2 = std::chrono::steady_clock::now();
  std::atomic<long> total_assoc{0};
  std::vector<std::thread> pool;
  size_t n = reads.size();
  std::vector<std::vector<std::pair<uint32_t, uint16_t>>> dumped(
      dump ? threads : 0);
  for (int t = 0; t < threads; t++) {
    pool.emplace_back([&, t]() {
      long local = 0;
      std::vector<uint16_t> wins;
      for (size_t i = t; i < n; i += threads) {
        if (dump) {
          wins.clear();
          local += classify(ix, reads[i], k, c, &wins);
          for (uint16_t g : wins) dumped[t].push_back({(uint32_t)i, g});
        } else {
          local += classify(ix, reads[i], k, c);
        }
      }
      total_assoc += local;
    });
  }
  for (auto& th : pool) th.join();
  auto t3 = std::chrono::steady_clock::now();

  if (dump) {
    std::vector<std::pair<uint32_t, uint16_t>> all;
    for (auto& v : dumped) all.insert(all.end(), v.begin(), v.end());
    std::sort(all.begin(), all.end());
    FILE* f = fopen(dump, "w");
    if (!f) { fprintf(stderr, "cannot open dump %s\n", dump); return 1; }
    for (auto& pg : all) fprintf(f, "%u %u\n", pg.first, (unsigned)pg.second);
    fclose(f);
  }

  double build_s = std::chrono::duration<double>(t1 - t0).count();
  double classify_s = std::chrono::duration<double>(t3 - t2).count();
  printf("{\"n_reads\": %zu, \"n_associations\": %ld, \"build_s\": %.3f, "
         "\"classify_s\": %.3f, \"reads_per_sec\": %.1f, \"threads\": %d}\n",
         n, total_assoc.load(), build_s, classify_s,
         (double)n / classify_s, threads);
  return 0;
}
