// Shared fused-scan result model (bamdecode.cpp + cramdecode.cpp).
//
// Both ingestion paths — the BAM chain walk and the CRAM slice decoder —
// produce the SAME handle shape: per-contig statistic runs plus the
// filtered coverage-block arrays, consumed by ct_stats_fill /
// ct_stats_free (bamdecode.cpp).  CRAM slices populate one ChunkOut per
// slice; the BAM pipeline one per 32k-record chunk.
#pragma once

#include <cstdint>
#include <vector>

namespace covermio {

struct StatsRun {
  int32_t tid;
  int64_t reads_primary, reads_nonsupp, reads_all;
  int64_t nm_sum, indel_sum, block_count;
  double ident_primary, ident_nonsupp;
};

struct ChunkOut {
  std::vector<StatsRun> runs;
  std::vector<int32_t> btid, bstart, bend;
  int64_t n_primary = 0;    // primary alignments among ALL records
  int64_t nm_missing = 0;   // passing mapped records lacking NM
  int32_t first_tid = -1, last_tid = -1;  // over passing mapped records
  bool sorted = true;
  int64_t err = 0;  // (record index within chunk)+1 on malformed input
};

struct StatsScanState {
  std::vector<ChunkOut> chunks;
  int64_t n_chunks = 0;
  int64_t n_records = 0, end_off = 0, n_blocks = 0;
  uint8_t* buf = nullptr;   // ingest path: owned decode buffer
  int64_t buf_len = 0;
};

}  // namespace covermio
