// Native Parquet row-group reader kernel (petastorm_tpu_torch).
//
// The port's own copy of petastorm_tpu/native/rowgroup_reader.cpp, whole
// below this header: the Arrow C stream read, the zero-copy page scan, the
// fused read->decode->collate with its first-party snappy/ZSTD/LZ4
// decompressors, and the predicate kernel (not bound by the port yet). One
// change: the thrift skipper counts a bool key or value of a map as one byte
// (TReader::skip_value), where the JAX copy loops on a corrupt map of bools.
// The ABI literal pstpu_abi_version() must equal EXPECTED_ABI in fused.py.
//
// The reference delegates all Parquet decode to pyarrow (Arrow C++) through
// Python (reference py_dict_reader_worker.py:254-258, arrow_reader_worker.py).
// This kernel is the framework's first-party native component (SURVEY.md
// §2.10): it opens a Parquet file, reads selected columns of one row group on
// C++ threads (no GIL), and hands the decoded Arrow table back to Python
// zero-copy through the Arrow C Data Interface (ArrowArrayStream).
//
// C ABI only — bound from Python with ctypes (no pybind11 in this image).
//
// Build: python -m petastorm_tpu_torch.native.build  (links pyarrow's bundled
// libarrow/libparquet; C++20 for std::span in Arrow 25 headers).

#include <arrow/api.h>
#include <arrow/c/bridge.h>
#include <arrow/io/file.h>
#include <arrow/util/config.h>
#include <parquet/arrow/reader.h>
#include <parquet/file_reader.h>
#include <parquet/metadata.h>
#include <parquet/properties.h>

// parquet::arrow::FileReader factory/read APIs: Status + out-param in the
// long-stable wheels (<= 22), arrow::Result returns in the newer ones the
// original kernel targeted. Support both; a mismatch merely disables the
// kernel (build failure -> pure-pyarrow fallback), but matching here keeps
// the native path alive across the pyarrow versions the fleet actually runs.
#define PSTPU_ARROW_RESULT_APIS (ARROW_VERSION_MAJOR >= 23)

#include <fcntl.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

struct FileHandle {
  std::unique_ptr<parquet::arrow::FileReader> reader;
  std::shared_ptr<parquet::FileMetaData> metadata;
  int fd = -1;  // borrowed from the underlying ReadableFile (it owns closing)
  // parquet::arrow::FileReader is not thread-safe for concurrent reads of the
  // same handle; worker threads each own a handle, but guard anyway so a
  // shared handle degrades to serialized reads instead of corruption.
  std::mutex mutex;
};

// Best-effort page-cache readahead of the column chunks the caller is about
// to decode (the SELECTED columns only — advising the whole group would
// defeat column projection's IO savings on wide tables). A cold-cache decode
// otherwise interleaves demand-paged 64-128KB reads with CPU work; WILLNEED
// lets the kernel stream each chunk's compressed range ahead of the decoder.
// No next-group prefetch: the ventilator shuffles piece order, so "i+1 of
// this file" is almost never what gets read next.
void advise_row_group(FileHandle* h, int i, const int* columns, int n_columns) {
#if defined(POSIX_FADV_WILLNEED)
  if (h->fd < 0 || i < 0 || i >= h->metadata->num_row_groups()) return;
  auto rg = h->metadata->RowGroup(i);
  const bool subset = columns != nullptr && n_columns >= 0;
  const int count = subset ? n_columns : rg->num_columns();
  for (int k = 0; k < count; k++) {
    const int c = subset ? columns[k] : k;
    if (c < 0 || c >= rg->num_columns()) continue;
    auto col = rg->ColumnChunk(c);
    int64_t chunk_start = col->data_page_offset();
    if (col->has_dictionary_page() && col->dictionary_page_offset() > 0) {
      chunk_start = std::min(chunk_start, col->dictionary_page_offset());
    }
    const int64_t len = col->total_compressed_size();
    if (len > 0) (void)posix_fadvise(h->fd, chunk_start, len, POSIX_FADV_WILLNEED);
  }
#else
  (void)h;
  (void)i;
  (void)columns;
  (void)n_columns;
#endif
}

}  // namespace

extern "C" {

const char* pstpu_last_error() { return g_last_error.c_str(); }

// Open a local Parquet file. use_threads!=0 enables Arrow-internal parallel
// column decode; buffer_size>0 enables read coalescing into buffers of that
// size (useful on high-latency storage; 0 = plain reads).
void* pstpu_open(const char* path, int use_threads, long long buffer_size) {
  auto maybe_file = arrow::io::ReadableFile::Open(path);
  if (!maybe_file.ok()) {
    set_error(maybe_file.status().ToString());
    return nullptr;
  }
  parquet::ReaderProperties props = parquet::default_reader_properties();
  if (buffer_size > 0) {
    props.enable_buffered_stream();
    props.set_buffer_size(buffer_size);
  }
  std::unique_ptr<parquet::ParquetFileReader> pq_reader;
  try {
    pq_reader = parquet::ParquetFileReader::Open(*maybe_file, props);
  } catch (const std::exception& e) {
    set_error(e.what());
    return nullptr;
  }
  auto handle = std::make_unique<FileHandle>();
  handle->fd = (*maybe_file)->file_descriptor();
  handle->metadata = pq_reader->metadata();
  parquet::ArrowReaderProperties arrow_props;
  arrow_props.set_use_threads(use_threads != 0);
#if PSTPU_ARROW_RESULT_APIS
  auto maybe_reader = parquet::arrow::FileReader::Make(
      arrow::default_memory_pool(), std::move(pq_reader), arrow_props);
  if (!maybe_reader.ok()) {
    set_error(maybe_reader.status().ToString());
    return nullptr;
  }
  handle->reader = std::move(*maybe_reader);
#else
  auto st = parquet::arrow::FileReader::Make(
      arrow::default_memory_pool(), std::move(pq_reader), arrow_props,
      &handle->reader);
  if (!st.ok()) {
    set_error(st.ToString());
    return nullptr;
  }
#endif
  return handle.release();
}

void pstpu_close(void* h) { delete static_cast<FileHandle*>(h); }

int pstpu_num_row_groups(void* h) {
  return static_cast<FileHandle*>(h)->metadata->num_row_groups();
}

long long pstpu_num_rows(void* h) {
  return static_cast<FileHandle*>(h)->metadata->num_rows();
}

long long pstpu_row_group_num_rows(void* h, int row_group) {
  auto* handle = static_cast<FileHandle*>(h);
  if (row_group < 0 || row_group >= handle->metadata->num_row_groups()) {
    set_error("row group index out of range");
    return -1;
  }
  return handle->metadata->RowGroup(row_group)->num_rows();
}

// Number of leaf (physical) parquet columns.
int pstpu_num_columns(void* h) {
  return static_cast<FileHandle*>(h)->metadata->num_columns();
}

// Write the dot-joined path of leaf column `i` into buf; returns length or -1.
int pstpu_column_name(void* h, int i, char* buf, int buf_len) {
  auto* handle = static_cast<FileHandle*>(h);
  if (i < 0 || i >= handle->metadata->num_columns()) {
    set_error("column index out of range");
    return -1;
  }
  const std::string name =
      handle->metadata->schema()->Column(i)->path()->ToDotString();
  if (static_cast<int>(name.size()) + 1 > buf_len) {
    set_error("column name buffer too small");
    return -1;
  }
  std::memcpy(buf, name.c_str(), name.size() + 1);
  return static_cast<int>(name.size());
}

// Read one row group (optionally a subset of leaf columns) into an
// ArrowArrayStream. Decode runs on Arrow C++ threads; the stream is consumed
// zero-copy by pyarrow on the Python side.
int pstpu_read_row_group(void* h, int row_group, const int* columns,
                         int n_columns, struct ArrowArrayStream* out) {
  auto* handle = static_cast<FileHandle*>(h);
  std::lock_guard<std::mutex> lock(handle->mutex);
  if (row_group < 0 || row_group >= handle->metadata->num_row_groups()) {
    set_error("row group index out of range");
    return -1;
  }
  advise_row_group(handle, row_group, columns, n_columns);
  std::shared_ptr<arrow::Table> table;
#if PSTPU_ARROW_RESULT_APIS
  arrow::Result<std::shared_ptr<arrow::Table>> maybe_table =
      (columns != nullptr && n_columns >= 0)
          ? handle->reader->ReadRowGroup(row_group,
                                         std::vector<int>(columns, columns + n_columns))
          : handle->reader->ReadRowGroup(row_group);
  if (!maybe_table.ok()) {
    set_error(maybe_table.status().ToString());
    return -1;
  }
  table = *maybe_table;
#else
  arrow::Status read_st =
      (columns != nullptr && n_columns >= 0)
          ? handle->reader->ReadRowGroup(
                row_group, std::vector<int>(columns, columns + n_columns), &table)
          : handle->reader->ReadRowGroup(row_group, &table);
  if (!read_st.ok()) {
    set_error(read_st.ToString());
    return -1;
  }
#endif
  // hand ownership of the decoded batches to the stream
  arrow::TableBatchReader batch_reader(*table);
  std::vector<std::shared_ptr<arrow::RecordBatch>> batches;
  while (true) {
    std::shared_ptr<arrow::RecordBatch> batch;
    auto st = batch_reader.ReadNext(&batch);
    if (!st.ok()) {
      set_error(st.ToString());
      return -1;
    }
    if (batch == nullptr) break;
    batches.push_back(std::move(batch));
  }
  auto maybe_reader =
      arrow::RecordBatchReader::Make(std::move(batches), table->schema());
  if (!maybe_reader.ok()) {
    set_error(maybe_reader.status().ToString());
    return -1;
  }
  auto st = arrow::ExportRecordBatchReader(*maybe_reader, out);
  if (!st.ok()) {
    set_error(st.ToString());
    return -1;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// First-party Parquet page scan — the zero-copy fast path.
//
// For UNCOMPRESSED, PLAIN-encoded, REQUIRED (max_def_level==0) fixed-width
// columns — the layout RawTensorCodec stores produce — a page's values region
// is byte-identical to the Arrow data buffer, so decode is a VIEW over the
// mmapped file instead of Arrow's assemble-and-copy. The only parsing needed
// is the page headers, which are thrift compact-protocol structs; the minimal
// reader below parses exactly the PageHeader/DataPageHeader fields the scan
// needs and generically skips everything else (statistics, crc, ...). No
// Arrow involvement: a parse error or any unsupported feature returns -1 and
// the caller falls back to the Arrow path above.
// ---------------------------------------------------------------------------

namespace {

// Deepest nested container/struct chain the generic skipper will follow. Real
// PageHeaders nest 2-3 levels; a crafted/corrupt header nesting deeper is
// hostile input that must set ok=false (-> Arrow fallback), NOT recurse until
// the C++ stack overflows and kills the process (PT502).
constexpr int kMaxSkipDepth = 32;

struct TReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint8_t byte() {
    if (p >= end) { ok = false; return 0; }
    return *p++;
  }
  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (ok) {
      const uint8_t b = byte();
      v |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) { ok = false; break; }
    }
    return v;
  }
  int64_t zigzag() {
    const uint64_t v = varint();
    return int64_t(v >> 1) ^ -int64_t(v & 1);
  }
  void skip_bytes(uint64_t n) {
    if (uint64_t(end - p) < n) { ok = false; return; }
    p += n;
  }
  void skip_value(int type, int depth);  // forward (recursive for containers)
  void skip_struct(int depth) {
    if (depth > kMaxSkipDepth) { ok = false; return; }
    while (ok) {
      const uint8_t head = byte();
      if (head == 0) return;  // STOP
      if ((head & 0x0F) == 0) { ok = false; return; }
      if ((head >> 4) == 0) (void)zigzag();  // long-form field id
      skip_value(head & 0x0F, depth);
    }
  }
};

void TReader::skip_value(int type, int depth) {
  if (depth > kMaxSkipDepth) { ok = false; return; }
  switch (type) {
    case 1: case 2: return;             // bool true/false: value in the nibble
    case 3: skip_bytes(1); return;      // byte (raw, not varint)
    case 4: case 5: case 6: (void)zigzag(); return;  // i16/i32/i64
    case 7: skip_bytes(8); return;      // double
    case 8: skip_bytes(varint()); return;  // binary/string
    case 9: case 10: {                  // list/set
      const uint8_t head = byte();
      uint64_t n = head >> 4;
      if (n == 0xF) n = varint();
      const int elem = head & 0x0F;
      for (uint64_t i = 0; i < n && ok; i++) {
        if (elem == 1 || elem == 2) skip_bytes(1);  // bool element: one byte
        else skip_value(elem, depth + 1);
      }
      return;
    }
    case 11: {                          // map
      const uint64_t n = varint();
      if (n == 0) return;
      const uint8_t kv = byte();
      // a bool key or value in a map is one byte, as in a list: skipped as
      // a bare field bool (no byte), a map of bools with a corrupt count of
      // up to 2^64 entries consumed nothing and never ended
      const int types[2] = {kv >> 4, kv & 0x0F};
      for (uint64_t i = 0; i < n && ok; i++) {
        for (const int t : types) {
          if (t == 1 || t == 2) skip_bytes(1);
          else skip_value(t, depth + 1);
        }
      }
      return;
    }
    case 12: skip_struct(depth + 1); return;  // struct
    default: ok = false; return;
  }
}

struct PageInfo {
  int32_t page_type = -1;          // 0=DATA_PAGE, 2=DICTIONARY_PAGE, 3=DATA_PAGE_V2
  int64_t uncompressed_size = -1;
  int64_t compressed_size = -1;
  int64_t num_values = -1;
  int32_t encoding = -1;           // DataPageHeader(.V2).encoding; 0=PLAIN
  int32_t def_level_encoding = -1; // DataPageHeader field 3; 3=RLE
  int64_t dict_num_values = -1;    // DictionaryPageHeader field 1
  int32_t dict_encoding = -1;      // DictionaryPageHeader field 2; 0/2=PLAIN
  // DATA_PAGE_V2 only (DataPageHeaderV2, PageHeader field 8): the def/rep
  // level blocks are an UNCOMPRESSED prefix of the page body with explicit
  // byte lengths, and compression (field 7, default true) covers the data
  // region alone
  int64_t v2_num_nulls = -1;
  int64_t v2_def_len = -1;
  int64_t v2_rep_len = -1;
  int32_t v2_is_compressed = 1;
  // page-header Statistics (DataPageHeader field 5 / DataPageHeaderV2 field
  // 8): min_value/max_value point INTO the page-header bytes; -1 len = absent
  const uint8_t* stat_min = nullptr;
  const uint8_t* stat_max = nullptr;
  int64_t stat_min_len = -1;
  int64_t stat_max_len = -1;
  int64_t stat_null_count = -1;
  uint64_t header_len = 0;
};

// Statistics struct fields: 3=null_count(i64), 5=max_value, 6=min_value
// (the untyped legacy min/max at ids 1/2 are deliberately ignored)
void parse_statistics(TReader& r, PageInfo* info) {
  int16_t inner_last = 0;
  while (r.ok) {
    const uint8_t ih = r.byte();
    if (ih == 0) break;
    const int itype = ih & 0x0F;
    int16_t iid = (ih >> 4) == 0 ? int16_t(r.zigzag())
                                 : int16_t(inner_last + (ih >> 4));
    inner_last = iid;
    if (iid == 3 && itype == 6) {
      info->stat_null_count = r.zigzag();
    } else if ((iid == 5 || iid == 6) && itype == 8) {
      const uint64_t len = r.varint();
      if (!r.ok || uint64_t(r.end - r.p) < len) { r.ok = false; return; }
      if (iid == 5) { info->stat_max = r.p; info->stat_max_len = int64_t(len); }
      else { info->stat_min = r.p; info->stat_min_len = int64_t(len); }
      r.skip_bytes(len);
    } else {
      r.skip_value(itype, 0);
    }
  }
}

// Parse one compact-protocol PageHeader starting at r.p; fills `info`.
bool parse_page_header(TReader& r, PageInfo* info) {
  const uint8_t* start = r.p;
  int16_t last_id = 0;
  while (r.ok) {
    const uint8_t head = r.byte();
    if (head == 0) break;  // STOP
    const int type = head & 0x0F;
    int16_t id;
    if ((head >> 4) == 0) {
      id = int16_t(r.zigzag());
    } else {
      id = int16_t(last_id + (head >> 4));
    }
    last_id = id;
    if (id == 1 && type == 5) {
      info->page_type = int32_t(r.zigzag());
    } else if (id == 2 && type == 5) {
      info->uncompressed_size = r.zigzag();
    } else if (id == 3 && type == 5) {
      info->compressed_size = r.zigzag();
    } else if (id == 5 && type == 12) {  // DataPageHeader
      int16_t inner_last = 0;
      while (r.ok) {
        const uint8_t ih = r.byte();
        if (ih == 0) break;
        const int itype = ih & 0x0F;
        int16_t iid = (ih >> 4) == 0 ? int16_t(r.zigzag())
                                     : int16_t(inner_last + (ih >> 4));
        inner_last = iid;
        if (iid == 1 && itype == 5) info->num_values = r.zigzag();
        else if (iid == 2 && itype == 5) info->encoding = int32_t(r.zigzag());
        else if (iid == 3 && itype == 5) info->def_level_encoding = int32_t(r.zigzag());
        else if (iid == 5 && itype == 12) parse_statistics(r, info);
        else r.skip_value(itype, 0);
      }
    } else if (id == 7 && type == 12) {  // DictionaryPageHeader
      int16_t inner_last = 0;
      while (r.ok) {
        const uint8_t ih = r.byte();
        if (ih == 0) break;
        const int itype = ih & 0x0F;
        int16_t iid = (ih >> 4) == 0 ? int16_t(r.zigzag())
                                     : int16_t(inner_last + (ih >> 4));
        inner_last = iid;
        if (iid == 1 && itype == 5) info->dict_num_values = r.zigzag();
        else if (iid == 2 && itype == 5) info->dict_encoding = int32_t(r.zigzag());
        else r.skip_value(itype, 0);
      }
    } else if (id == 8 && type == 12) {  // DataPageHeaderV2
      int16_t inner_last = 0;
      while (r.ok) {
        const uint8_t ih = r.byte();
        if (ih == 0) break;
        const int itype = ih & 0x0F;
        int16_t iid = (ih >> 4) == 0 ? int16_t(r.zigzag())
                                     : int16_t(inner_last + (ih >> 4));
        inner_last = iid;
        if (iid == 1 && itype == 5) info->num_values = r.zigzag();
        else if (iid == 2 && itype == 5) info->v2_num_nulls = r.zigzag();
        else if (iid == 4 && itype == 5) info->encoding = int32_t(r.zigzag());
        else if (iid == 5 && itype == 5) info->v2_def_len = r.zigzag();
        else if (iid == 6 && itype == 5) info->v2_rep_len = r.zigzag();
        else if (iid == 7 && (itype == 1 || itype == 2)) {
          // compact-protocol bool: the value IS the type nibble (1=true)
          info->v2_is_compressed = itype == 1 ? 1 : 0;
        } else if (iid == 8 && itype == 12) parse_statistics(r, info);
        else r.skip_value(itype, 0);
      }
    } else {
      r.skip_value(type, 0);
    }
  }
  info->header_len = uint64_t(r.p - start);
  return r.ok;
}

}  // namespace

extern "C" {

// Scan an in-memory Parquet column chunk of UNCOMPRESSED PLAIN v1 data
// pages. out_offsets[i] = byte offset of page i's VALUES region within
// `chunk`; out_counts[i] = its value count; out_value_lens[i] = the byte
// length of that values region (page end minus values start) — the PER-PAGE
// bound the caller must check count*itemsize against before building a
// zero-copy view (a wrong null_count statistic or a short page would
// otherwise serve the next page's header bytes as tensor data).
// `has_def_levels` != 0 means the column is OPTIONAL (max_def_level == 1):
// each page then leads with a 4-byte-length-prefixed RLE definition-levels
// block which is skipped — the caller is responsible for proving the chunk
// has ZERO nulls (statistics), since a null would make value count <
// num_values. Returns the page count, or -1 on any parse error or
// unsupported feature (dictionary page, v2 page, compression, non-PLAIN
// encoding, non-RLE def levels) — the caller then uses the Arrow path.
long long pstpu_scan_plain_pages(const uint8_t* chunk, unsigned long long chunk_len,
                                 unsigned long long* out_offsets,
                                 long long* out_counts,
                                 unsigned long long* out_value_lens, int max_pages,
                                 int has_def_levels) {
  uint64_t pos = 0;
  int n = 0;
  while (pos < chunk_len) {
    TReader r{chunk + pos, chunk + chunk_len};
    PageInfo info;
    if (!parse_page_header(r, &info)) {
      set_error("page header parse failed");
      return -1;
    }
    if (info.page_type != 0 || info.encoding != 0 || info.num_values < 0 ||
        info.compressed_size < 0 ||
        info.compressed_size != info.uncompressed_size) {
      set_error("unsupported page (type/encoding/compression)");
      return -1;
    }
    uint64_t data_off = pos + info.header_len;
    const uint64_t page_end = pos + info.header_len + uint64_t(info.compressed_size);
    if (page_end > chunk_len) {
      set_error("page overruns chunk");
      return -1;
    }
    if (has_def_levels) {
      if (info.def_level_encoding != 3) {  // RLE; BIT_PACKED legacy unsupported
        set_error("unsupported definition-level encoding");
        return -1;
      }
      if (data_off + 4 > page_end) {
        set_error("def-levels length overruns page");
        return -1;
      }
      uint32_t def_len;
      std::memcpy(&def_len, chunk + data_off, 4);  // little-endian host
      data_off += 4 + def_len;
      if (data_off > page_end) {
        set_error("def-levels block overruns page");
        return -1;
      }
    }
    if (n >= max_pages) {
      set_error("more pages than max_pages");
      return -1;
    }
    out_offsets[n] = data_off;
    out_counts[n] = info.num_values;
    out_value_lens[n] = page_end - data_off;
    n++;
    pos = page_end;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused batch decode — read→decode→collate in ONE native call.
//
// The page scan above still hands each column back to Python (one ctypes call
// + Arrow view + collate per column per batch), and forfeits any dictionary-
// or RLE-encoded chunk to Arrow. pstpu_read_fused removes that tail: for a
// whole batch of columns it walks the page headers, decompresses SNAPPY pages
// first-party, decodes PLAIN *and* dictionary/RLE-bit-packed-hybrid values,
// and writes every column's rows into a caller-provided contiguous batch
// buffer — optionally an shm-ring slot the consumer maps — on C++ worker
// threads with the GIL released. Python touches the result exactly once per
// batch. Binary columns come in two fused flavors: uniform raw cells (npy
// payloads, headers stripped) and encoded images, which are decoded through
// the batched image-codec entry points passed in as function pointers so the
// whole read→decode→collate chain is one transition.
//
// Every parse is bounds-checked against the chunk/page/output regions and
// every failure is a per-column status code — the caller falls back to the
// Arrow path for that column and accounts the reason, never crashes.
// ---------------------------------------------------------------------------

namespace {

// First-party snappy *decompressor* (format_description.txt): varint preamble
// with the uncompressed length, then literal/copy elements. Decode-only — the
// write path never emits snappy from here. All reads are bounds-checked; any
// malformed element returns false and the column falls back to Arrow.
bool read_uvarint(const uint8_t** pp, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  const uint8_t* p = *pp;
  while (p < end && shift <= 28) {  // 5 bytes max: 35 bits covers lengths/runs
    const uint8_t b = *p++;
    v |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *pp = p;
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool snappy_uncompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t dst_len) {
  const uint8_t* p = src;
  const uint8_t* end = src + n;
  uint64_t expect = 0;
  if (!read_uvarint(&p, end, &expect) || expect != dst_len) return false;
  uint64_t d = 0;
  while (p < end) {
    const uint8_t tag = *p++;
    if ((tag & 3) == 0) {  // literal
      uint64_t len = tag >> 2;
      if (len >= 60) {
        const int extra = int(len) - 59;  // 1..4 little-endian length bytes
        if (end - p < extra) return false;
        len = 0;
        for (int i = 0; i < extra; i++) len |= uint64_t(p[i]) << (8 * i);
        p += extra;
      }
      len += 1;
      if (uint64_t(end - p) < len || dst_len - d < len) return false;
      std::memcpy(dst + d, p, len);
      p += len;
      d += len;
    } else {  // copy
      uint64_t len, off;
      if ((tag & 3) == 1) {
        if (p >= end) return false;
        len = ((tag >> 2) & 7) + 4;
        off = (uint64_t(tag & 0xE0) << 3) | *p++;
      } else if ((tag & 3) == 2) {
        if (end - p < 2) return false;
        len = (tag >> 2) + 1;
        off = uint64_t(p[0]) | (uint64_t(p[1]) << 8);
        p += 2;
      } else {
        if (end - p < 4) return false;
        len = (tag >> 2) + 1;
        off = uint64_t(p[0]) | (uint64_t(p[1]) << 8) |
              (uint64_t(p[2]) << 16) | (uint64_t(p[3]) << 24);
        p += 4;
      }
      if (off == 0 || off > d || dst_len - d < len) return false;
      const uint8_t* s = dst + (d - off);
      if (off >= len) {
        std::memcpy(dst + d, s, len);
      } else {
        for (uint64_t i = 0; i < len; i++) dst[d + i] = s[i];  // overlapping run
      }
      d += len;
    }
  }
  return d == expect;
}

// RLE / bit-packed hybrid decoder (<bit-width:1 byte> precedes this stream in
// dictionary-encoded data pages; def-level blocks carry the width implicitly).
// Emits exactly `count` values; trailing runs may overhang and are clamped.
// Zero-length runs/groups are rejected so progress is guaranteed.
bool decode_hybrid(const uint8_t* p, const uint8_t* end, int bw, int64_t count,
                   std::vector<uint32_t>* out) {
  if (bw < 0 || bw > 32 || count < 0) return false;
  out->clear();
  out->reserve(size_t(count));
  if (bw == 0) {
    out->assign(size_t(count), 0);
    return true;
  }
  const uint32_t mask = (bw == 32) ? 0xFFFFFFFFu : ((1u << bw) - 1);
  const int vbytes = (bw + 7) / 8;
  while (int64_t(out->size()) < count) {
    uint64_t header = 0;
    if (!read_uvarint(&p, end, &header)) return false;
    const uint64_t remaining = uint64_t(count) - out->size();
    if (header & 1) {  // bit-packed: (header>>1) groups of 8 values
      const uint64_t groups = header >> 1;
      if (groups == 0) return false;
      // division form: groups * bw would wrap for a corrupt huge group count,
      // sneaking a tiny nbytes past the bounds check below
      if (groups > uint64_t(end - p) / uint64_t(bw)) return false;
      const uint64_t nbytes = groups * uint64_t(bw);
      const uint64_t take = std::min<uint64_t>(groups * 8, remaining);
      uint64_t bit = 0;
      for (uint64_t i = 0; i < take; i++) {
        const uint64_t byte_idx = bit >> 3;
        uint64_t word = 0;
        const uint64_t avail = nbytes - byte_idx;
        std::memcpy(&word, p + byte_idx, avail < 8 ? size_t(avail) : size_t(8));
        out->push_back(uint32_t(word >> (bit & 7)) & mask);
        bit += uint64_t(bw);
      }
      p += nbytes;
    } else {  // RLE run
      const uint64_t run = header >> 1;
      if (run == 0) return false;
      if (end - p < vbytes) return false;
      uint32_t v = 0;
      for (int i = 0; i < vbytes; i++) v |= uint32_t(p[i]) << (8 * i);
      p += vbytes;
      out->insert(out->end(), size_t(std::min<uint64_t>(run, remaining)), v & mask);
    }
  }
  return true;
}

// per-column status codes — keep in sync with native/fused.py REASONS
enum {
  kColOk = 0,
  kColParse = 1,       // thrift/page/snappy parse failure
  kColPageType = 2,    // v2 page or unknown page type
  kColEncoding = 3,    // unsupported value/level encoding
  kColCompressed = 4,  // unsupported codec / size mismatch
  kColDefLevels = 5,   // def-levels block malformed
  kColPageCap = 6,     // more pages than max_pages
  kColRows = 7,        // decoded rows != expected_rows
  kColBounds = 8,      // values/output region bounds violation
  kColDict = 9,        // dictionary missing/invalid for an indexed page
  kColNonUniform = 10, // binary cells not uniform (raw mode)
  kColImgProbe = 11,
  kColImgDims = 12,
  kColImgDecode = 13,
  kColInternal = 14,   // unexpected native failure (e.g. allocation)
};

enum { kModeFixed = 0, kModeBinaryRaw = 1, kModeBinaryImg = 2 };
enum { kCodecUncompressed = 0, kCodecSnappy = 1, kCodecZstd = 2,
       kCodecLz4Raw = 3, kCodecLz4 = 4 };

// ---------------------------------------------------------------------------
// first-party ZSTD (RFC 8878) and LZ4 (raw block / frame / hadoop-framed)
// decompressors. Byte-index style throughout: positions are unsigned indexes
// validated against the buffer length before any access, and every output
// write is bounded by the caller-provided destination capacity.

inline int highbit_u64(uint64_t v) { return 63 - __builtin_clzll(v); }

// forward bit reader (FSE table descriptions); LSB-first within bytes
struct FwdBits {
  const uint8_t* base;
  uint64_t nbytes;
  uint64_t bitpos = 0;
  bool ok = true;
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    if (nb > 57 || !ok) { ok = false; return 0; }
    uint64_t end_bit = bitpos + uint64_t(nb);
    if (end_bit > nbytes * 8) { ok = false; return 0; }
    uint64_t first = bitpos >> 3, last = (end_bit - 1) >> 3;
    uint64_t acc = 0;
    for (uint64_t i = last + 1; i > first; i--) acc = (acc << 8) | base[i - 1];
    acc >>= (bitpos & 7);
    bitpos = end_bit;
    return acc & ((uint64_t(1) << nb) - 1);
  }
  void rewind(int nb) { bitpos -= uint64_t(nb); }
  void align() { bitpos = (bitpos + 7) & ~uint64_t(7); }
  uint64_t consumed_bytes() const { return (bitpos + 7) >> 3; }
};

// backward bit reader (huffman streams, sequence execution). The stream ends
// with a 1-bit sentinel in its last nonzero byte; `pos` counts the unread
// bits below the sentinel and is allowed to go negative only via read_pad
// (zero-padding convention used by huffman state reloads).
struct BackBits {
  const uint8_t* base = nullptr;
  int64_t pos = 0;  // bits [0, pos) of the stream remain unread
  bool ok = true;
  bool init(const uint8_t* p, uint64_t n) {
    base = p;
    if (n == 0 || p[n - 1] == 0) return false;
    pos = int64_t((n - 1) * 8) + highbit_u64(p[n - 1]);
    return true;
  }
  uint64_t gather(int64_t lo, int nb) const {
    if (nb == 0) return 0;
    int64_t hi = lo + nb - 1;
    uint64_t acc = 0;
    for (int64_t i = hi >> 3; i >= lo >> 3; i--) acc = (acc << 8) | base[i];
    acc >>= (uint64_t(lo) & 7);
    return acc & ((uint64_t(1) << nb) - 1);
  }
  // exact read: fails when fewer than nb bits remain
  uint64_t read(int nb) {
    if (nb == 0) return 0;
    if (!ok || nb > 57 || pos < int64_t(nb)) { ok = false; return 0; }
    pos -= nb;
    return gather(pos, nb);
  }
  // padded read: missing low bits come back as zero, pos goes negative
  uint64_t read_pad(int nb) {
    if (nb == 0) return 0;
    if (!ok || nb > 57) { ok = false; return 0; }
    if (pos <= 0) { pos -= nb; return 0; }
    if (pos < int64_t(nb)) {
      uint64_t v = gather(0, int(pos)) << (nb - int(pos));
      pos -= nb;
      return v;
    }
    pos -= nb;
    return gather(pos, nb);
  }
};

struct FseTable {
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;
  std::vector<uint16_t> base;
  int accuracy_log = 0;
};

bool fse_build(FseTable* t, const int16_t* probs, int n_sym, int accuracy_log) {
  // accuracy_log 5 is the spec minimum; 9 covers every table this decoder
  // builds (LL/ML max 9, OF max 8, huffman-weights max 6). The bound also
  // keeps the spread step coprime with the table size.
  if (accuracy_log < 5 || accuracy_log > 9) return false;
  if (n_sym < 1 || n_sym > 256) return false;
  int size = 1 << accuracy_log;
  int64_t total = 0;
  for (int s = 0; s < n_sym; s++) {
    if (probs[s] < -1) return false;
    total += probs[s] == -1 ? 1 : probs[s];
  }
  if (total != size) return false;
  t->symbol.assign(size_t(size), 0);
  t->nbits.assign(size_t(size), 0);
  t->base.assign(size_t(size), 0);
  t->accuracy_log = accuracy_log;
  int high = size;
  for (int s = 0; s < n_sym; s++) {
    if (probs[s] == -1) t->symbol[size_t(--high)] = uint8_t(s);
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < n_sym; s++) {
    for (int i = 0; i < probs[s]; i++) {
      t->symbol[size_t(pos)] = uint8_t(s);
      do { pos = (pos + step) & mask; } while (pos >= high);
    }
  }
  if (pos != 0) return false;
  std::vector<int> next;
  next.resize(size_t(n_sym));
  for (int s = 0; s < n_sym; s++) next[size_t(s)] = probs[s] == -1 ? 1 : probs[s];
  for (int i = 0; i < size; i++) {
    int s = t->symbol[size_t(i)];
    int n = next[size_t(s)]++;
    // states run [prob, 2*prob): a symbol with probability above size/2
    // legitimately reaches n >= size (zero-bit transition, base = n - size)
    if (n <= 0 || n >= size * 2) return false;
    int nb = accuracy_log - highbit_u64(uint64_t(n));
    if (nb < 0 || nb > accuracy_log) return false;
    t->nbits[size_t(i)] = uint8_t(nb);
    t->base[size_t(i)] = uint16_t((n << nb) - size);
  }
  return true;
}

bool fse_read_distribution(FwdBits* bits, int16_t* probs, int max_sym,
                           int max_al, int* out_nsym, int* out_al) {
  int al = 5 + int(bits->read(4));
  if (!bits->ok || al > max_al) return false;
  int remaining = 1 << al;
  int symb = 0;
  while (remaining > 0 && symb < max_sym) {
    int nb = highbit_u64(uint64_t(remaining) + 1) + 1;
    uint32_t val = uint32_t(bits->read(nb));
    if (!bits->ok) return false;
    uint32_t lower_mask = (uint32_t(1) << (nb - 1)) - 1;
    uint32_t threshold = (uint32_t(1) << nb) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      bits->rewind(1);
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    probs[symb++] = int16_t(proba);
    if (proba == 0) {
      int repeat = int(bits->read(2));
      while (bits->ok) {
        for (int i = 0; i < repeat && symb < max_sym; i++) probs[symb++] = 0;
        if (repeat != 3) break;
        repeat = int(bits->read(2));
      }
      if (!bits->ok) return false;
    }
  }
  if (remaining != 0) return false;
  bits->align();
  *out_nsym = symb;
  *out_al = al;
  return true;
}

struct HufTable {
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;
  int max_bits = 0;
};

bool huf_build(HufTable* t, const uint8_t* weights, int n_weights) {
  if (n_weights < 1 || n_weights > 255) return false;
  uint64_t weight_sum = 0;
  for (int i = 0; i < n_weights; i++) {
    if (weights[i] > 11) return false;
    if (weights[i] > 0) weight_sum += uint64_t(1) << (weights[i] - 1);
  }
  if (weight_sum == 0) return false;
  int max_bits = highbit_u64(weight_sum) + 1;
  if (max_bits > 11) return false;
  uint64_t left = (uint64_t(1) << max_bits) - weight_sum;
  // the last symbol's weight is implicit: the remainder must be a power of 2
  if (left == 0 || (left & (left - 1)) != 0) return false;
  int n_sym = n_weights + 1;
  uint8_t w[256];
  for (int i = 0; i < n_weights; i++) w[i] = weights[i];
  w[n_weights] = uint8_t(highbit_u64(left) + 1);
  int size = 1 << max_bits;
  int nbits_of[256];
  int rank_count[13] = {0};
  for (int i = 0; i < n_sym; i++) {
    nbits_of[i] = w[i] == 0 ? 0 : max_bits + 1 - int(w[i]);
    if (nbits_of[i] > 0) rank_count[nbits_of[i]]++;
  }
  // longest codes occupy the lowest table indices
  uint32_t rank_idx[14] = {0};
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; b--) {
    uint32_t cells = uint32_t(rank_count[b]) * (uint32_t(1) << (max_bits - b));
    rank_idx[b - 1] = rank_idx[b] + cells;
  }
  if (rank_idx[0] != uint32_t(size)) return false;
  t->symbol.assign(size_t(size), 0);
  t->nbits.assign(size_t(size), 0);
  t->max_bits = max_bits;
  for (int i = 0; i < n_sym; i++) {
    if (nbits_of[i] == 0) continue;
    uint32_t code = rank_idx[nbits_of[i]];
    uint32_t len = uint32_t(1) << (max_bits - nbits_of[i]);
    if (code + len > uint32_t(size)) return false;
    for (uint32_t j = 0; j < len; j++) {
      t->symbol[code + j] = uint8_t(i);
      t->nbits[code + j] = uint8_t(nbits_of[i]);
    }
    rank_idx[nbits_of[i]] += len;
  }
  return true;
}

bool huf_decode_stream(const HufTable& t, BackBits* br, uint8_t* out,
                       uint64_t out_len) {
  uint64_t mask = (uint64_t(1) << t.max_bits) - 1;
  uint64_t state = br->read(t.max_bits);
  if (!br->ok) return false;
  for (uint64_t i = 0; i < out_len; i++) {
    out[i] = t.symbol[state];
    int nb = t.nbits[state];
    if (nb == 0) return false;
    state = ((state << nb) | br->read_pad(nb)) & mask;
    if (!br->ok) return false;
  }
  // a well-formed stream is consumed exactly: the final reload ran the
  // reader max_bits past empty (the initial state bits are not "owed back")
  return br->pos == -int64_t(t.max_bits);
}

bool huf_read_table(HufTable* t, const uint8_t* p, uint64_t n,
                    uint64_t* consumed) {
  if (n < 1) return false;
  int hb = p[0];
  uint8_t weights[256];
  int n_weights = 0;
  if (hb >= 128) {
    // direct 4-bit weights, high nibble first
    n_weights = hb - 127;
    uint64_t wbytes = (uint64_t(n_weights) + 1) / 2;
    if (n - 1 < wbytes) return false;
    for (int i = 0; i < n_weights; i++) {
      uint8_t b = p[1 + uint64_t(i >> 1)];
      weights[i] = (i & 1) ? (b & 0xF) : (b >> 4);
    }
    *consumed = 1 + wbytes;
  } else {
    // FSE-compressed weights: two interleaved states over a backward stream
    uint64_t csize = uint64_t(hb);
    if (csize == 0 || n - 1 < csize) return false;
    FwdBits fb{p + 1, csize};
    int16_t probs[256];
    int nsym = 0, al = 0;
    if (!fse_read_distribution(&fb, probs, 255, 6, &nsym, &al)) return false;
    FseTable ft;
    if (!fse_build(&ft, probs, nsym, al)) return false;
    uint64_t hdr = fb.consumed_bytes();
    if (csize <= hdr) return false;
    BackBits bb;
    if (!bb.init(p + 1 + hdr, csize - hdr)) return false;
    uint64_t s1 = bb.read(al), s2 = bb.read(al);
    if (!bb.ok) return false;
    while (true) {
      if (n_weights + 3 > 255) return false;
      weights[n_weights++] = ft.symbol[s1];
      s1 = uint64_t(ft.base[s1]) + bb.read_pad(ft.nbits[s1]);
      if (bb.pos < 0) { weights[n_weights++] = ft.symbol[s2]; break; }
      weights[n_weights++] = ft.symbol[s2];
      s2 = uint64_t(ft.base[s2]) + bb.read_pad(ft.nbits[s2]);
      if (bb.pos < 0) { weights[n_weights++] = ft.symbol[s1]; break; }
    }
    *consumed = 1 + csize;
  }
  return huf_build(t, weights, n_weights);
}

// RFC 8878 predefined sequence distributions and code→(baseline, extra-bits)
const int16_t kLLDefault[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
    -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// per-frame decode state: huffman table + sequence tables persist across
// blocks (treeless literals / repeat mode); repeat offsets reset per frame
struct ZstdCtx {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

bool zstd_literals(ZstdCtx* ctx, const uint8_t* p, uint64_t n,
                   uint64_t* consumed) {
  if (n < 1) return false;
  uint32_t b0 = p[0];
  int ltype = b0 & 3;
  int sf = (b0 >> 2) & 3;
  if (ltype == 0 || ltype == 1) {  // raw / RLE
    uint64_t hlen, rsize;
    if (sf == 0 || sf == 2) {
      hlen = 1;
      rsize = b0 >> 3;
    } else if (sf == 1) {
      if (n < 2) return false;
      hlen = 2;
      rsize = (b0 >> 4) | (uint64_t(p[1]) << 4);
    } else {
      if (n < 3) return false;
      hlen = 3;
      rsize = (b0 >> 4) | (uint64_t(p[1]) << 4) | (uint64_t(p[2]) << 12);
    }
    if (rsize > (uint64_t(1) << 20)) return false;
    if (ltype == 0) {
      if (n - hlen < rsize) return false;
      ctx->lits.assign(p + hlen, p + hlen + rsize);
      *consumed = hlen + rsize;
    } else {
      if (n - hlen < 1) return false;
      ctx->lits.assign(size_t(rsize), p[hlen]);
      *consumed = hlen + 1;
    }
    return true;
  }
  // huffman-compressed (2) or treeless (3, reuses the frame's last table)
  uint64_t hlen, rsize, csize;
  int n_streams;
  if (sf == 0 || sf == 1) {
    if (n < 3) return false;
    uint64_t h = b0 | (uint64_t(p[1]) << 8) | (uint64_t(p[2]) << 16);
    hlen = 3;
    n_streams = sf == 0 ? 1 : 4;
    rsize = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    if (n < 4) return false;
    uint64_t h = b0 | (uint64_t(p[1]) << 8) | (uint64_t(p[2]) << 16) |
                 (uint64_t(p[3]) << 24);
    hlen = 4;
    n_streams = 4;
    rsize = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    if (n < 5) return false;
    uint64_t h = b0 | (uint64_t(p[1]) << 8) | (uint64_t(p[2]) << 16) |
                 (uint64_t(p[3]) << 24) | (uint64_t(p[4]) << 32);
    hlen = 5;
    n_streams = 4;
    rsize = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
  }
  if (csize == 0 || n - hlen < csize) return false;
  if (rsize > (uint64_t(1) << 20)) return false;
  const uint8_t* body = p + hlen;
  uint64_t coff = 0;
  if (ltype == 2) {
    uint64_t tree_len = 0;
    if (!huf_read_table(&ctx->huf, body, csize, &tree_len)) return false;
    ctx->have_huf = true;
    coff = tree_len;
  } else if (!ctx->have_huf) {
    return false;
  }
  if (coff >= csize) return false;
  uint64_t slen = csize - coff;
  ctx->lits.assign(size_t(rsize), 0);
  if (n_streams == 1) {
    BackBits bb;
    if (!bb.init(body + coff, slen)) return false;
    if (!huf_decode_stream(ctx->huf, &bb, ctx->lits.data(), rsize)) return false;
  } else {
    if (slen < 6) return false;
    uint64_t s1 = body[coff] | (uint64_t(body[coff + 1]) << 8);
    uint64_t s2 = body[coff + 2] | (uint64_t(body[coff + 3]) << 8);
    uint64_t s3 = body[coff + 4] | (uint64_t(body[coff + 5]) << 8);
    if (s1 == 0 || s2 == 0 || s3 == 0) return false;
    if (s1 + s2 + s3 > slen - 6) return false;
    uint64_t s4 = slen - 6 - s1 - s2 - s3;
    if (s4 == 0) return false;
    uint64_t rchunk = (rsize + 3) / 4;
    if (3 * rchunk > rsize) return false;
    uint64_t sizes[4] = {s1, s2, s3, s4};
    uint64_t rsizes[4] = {rchunk, rchunk, rchunk, rsize - 3 * rchunk};
    uint64_t soff = coff + 6, roff = 0;
    for (int i = 0; i < 4; i++) {
      BackBits bb;
      if (!bb.init(body + soff, sizes[i])) return false;
      if (!huf_decode_stream(ctx->huf, &bb, ctx->lits.data() + roff, rsizes[i]))
        return false;
      soff += sizes[i];
      roff += rsizes[i];
    }
  }
  *consumed = hlen + csize;
  return true;
}

bool seq_table_for_mode(FseTable* t, bool* have, int mode,
                        const int16_t* defaults, int n_defaults, int default_al,
                        int max_al, int max_sym, const uint8_t* p, uint64_t n,
                        uint64_t* ip) {
  if (mode == 0) {  // predefined
    *have = fse_build(t, defaults, n_defaults, default_al);
    return *have;
  }
  if (mode == 1) {  // RLE: one symbol, zero-bit table
    if (*ip >= n) return false;
    uint8_t sym = p[*ip];
    *ip += 1;
    if (int(sym) >= max_sym) return false;
    t->symbol.assign(1, sym);
    t->nbits.assign(1, 0);
    t->base.assign(1, 0);
    t->accuracy_log = 0;
    *have = true;
    return true;
  }
  if (mode == 2) {  // FSE-described
    if (*ip >= n) return false;
    FwdBits fb{p + *ip, n - *ip};
    int16_t probs[64];
    int nsym = 0, al = 0;
    if (!fse_read_distribution(&fb, probs, max_sym, max_al, &nsym, &al))
      return false;
    if (!fse_build(t, probs, nsym, al)) return false;
    *ip += fb.consumed_bytes();
    *have = true;
    return true;
  }
  return *have;  // repeat: reuse the frame's previous table
}

bool zstd_sequences(ZstdCtx* ctx, const uint8_t* p, uint64_t n, uint8_t* dst,
                    uint64_t dst_cap, uint64_t* d_io, uint64_t frame_base) {
  uint64_t d = *d_io;
  uint64_t ip = 0;
  if (n < 1) return false;
  uint64_t nseq;
  uint32_t b0 = p[0];
  if (b0 < 128) {
    nseq = b0;
    ip = 1;
  } else if (b0 < 255) {
    if (n < 2) return false;
    nseq = ((uint64_t(b0) - 128) << 8) + p[1];
    ip = 2;
  } else {
    if (n < 3) return false;
    nseq = p[1] + (uint64_t(p[2]) << 8) + 0x7F00;
    ip = 3;
  }
  const uint64_t lit_total = ctx->lits.size();
  if (nseq == 0) {
    if (ip != n) return false;
    if (dst_cap - d < lit_total) return false;
    std::memcpy(dst + d, ctx->lits.data(), size_t(lit_total));
    *d_io = d + lit_total;
    return true;
  }
  if (n - ip < 1) return false;
  uint32_t modes = p[ip++];
  if ((modes & 3) != 0) return false;  // reserved bits
  int ll_mode = (modes >> 6) & 3;
  int of_mode = (modes >> 4) & 3;
  int ml_mode = (modes >> 2) & 3;
  if (!seq_table_for_mode(&ctx->ll, &ctx->have_ll, ll_mode, kLLDefault, 36, 6,
                          9, 36, p, n, &ip))
    return false;
  if (!seq_table_for_mode(&ctx->of, &ctx->have_of, of_mode, kOFDefault, 29, 5,
                          8, 32, p, n, &ip))
    return false;
  if (!seq_table_for_mode(&ctx->ml, &ctx->have_ml, ml_mode, kMLDefault, 53, 6,
                          9, 53, p, n, &ip))
    return false;
  if (ip >= n) return false;
  BackBits bb;
  if (!bb.init(p + ip, n - ip)) return false;
  uint64_t sll = bb.read(ctx->ll.accuracy_log);
  uint64_t sof = bb.read(ctx->of.accuracy_log);
  uint64_t sml = bb.read(ctx->ml.accuracy_log);
  if (!bb.ok) return false;
  uint64_t lit_off = 0;
  for (uint64_t seq = 0; seq < nseq; seq++) {
    uint32_t ll_code = ctx->ll.symbol[sll];
    uint32_t of_code = ctx->of.symbol[sof];
    uint32_t ml_code = ctx->ml.symbol[sml];
    if (ll_code > 35 || ml_code > 52 || of_code > 31) return false;
    uint64_t of_value = (uint64_t(1) << of_code) + bb.read(int(of_code));
    uint64_t ml_value = kMLBase[ml_code] + bb.read(kMLBits[ml_code]);
    uint64_t ll_value = kLLBase[ll_code] + bb.read(kLLBits[ll_code]);
    if (!bb.ok) return false;
    if (seq + 1 < nseq) {  // no state reload after the final sequence
      sll = uint64_t(ctx->ll.base[sll]) + bb.read(ctx->ll.nbits[sll]);
      sml = uint64_t(ctx->ml.base[sml]) + bb.read(ctx->ml.nbits[sml]);
      sof = uint64_t(ctx->of.base[sof]) + bb.read(ctx->of.nbits[sof]);
      if (!bb.ok) return false;
    }
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      ctx->rep[2] = ctx->rep[1];
      ctx->rep[1] = ctx->rep[0];
      ctx->rep[0] = offset;
    } else {
      uint64_t idx = of_value - 1 + (ll_value == 0 ? 1 : 0);
      if (idx == 0) {
        offset = ctx->rep[0];
      } else {
        offset = idx < 3 ? ctx->rep[idx] : ctx->rep[0] - 1;
        if (idx > 1) ctx->rep[2] = ctx->rep[1];
        ctx->rep[1] = ctx->rep[0];
        ctx->rep[0] = offset;
      }
    }
    if (offset == 0) return false;
    if (lit_total - lit_off < ll_value || lit_off > lit_total) return false;
    if (dst_cap - d < ll_value) return false;
    std::memcpy(dst + d, ctx->lits.data() + lit_off, size_t(ll_value));
    lit_off += ll_value;
    d += ll_value;
    if (offset > d - frame_base) return false;
    if (dst_cap - d < ml_value) return false;
    for (uint64_t i = 0; i < ml_value; i++) dst[d + i] = dst[d + i - offset];
    d += ml_value;
  }
  if (bb.pos != 0) return false;  // the sequence bitstream must be exact
  uint64_t tail = lit_total - lit_off;
  if (dst_cap - d < tail) return false;
  std::memcpy(dst + d, ctx->lits.data() + lit_off, size_t(tail));
  *d_io = d + tail;
  return true;
}

bool zstd_frame(ZstdCtx* ctx, const uint8_t* src, uint64_t src_len,
                uint64_t* ip_io, uint8_t* dst, uint64_t dst_len,
                uint64_t* d_io) {
  uint64_t ip = *ip_io;
  uint64_t d = *d_io;
  const uint64_t frame_base = d;  // match offsets may not cross frames
  if (src_len - ip < 1) return false;
  uint32_t fhd = src[ip++];
  if (fhd & 0x08) return false;  // reserved bit
  int fcs_code = fhd >> 6;
  bool single_segment = (fhd & 0x20) != 0;
  bool has_checksum = (fhd & 0x04) != 0;
  static const int kDidBytes[4] = {0, 1, 2, 4};
  int dbytes = kDidBytes[fhd & 3];
  if (!single_segment) {
    if (src_len - ip < 1) return false;
    ip++;  // window descriptor: all writes are bounded by dst_len instead
  }
  if (dbytes > 0) {
    if (src_len - ip < uint64_t(dbytes)) return false;
    uint64_t did = 0;
    for (int i = 0; i < dbytes; i++) did |= uint64_t(src[ip + i]) << (8 * i);
    ip += uint64_t(dbytes);
    if (did != 0) return false;  // dictionaries unsupported
  }
  int fcs_bytes;
  if (fcs_code == 0) fcs_bytes = single_segment ? 1 : 0;
  else if (fcs_code == 1) fcs_bytes = 2;
  else if (fcs_code == 2) fcs_bytes = 4;
  else fcs_bytes = 8;
  bool have_fcs = fcs_bytes > 0;
  uint64_t content_size = 0;
  if (have_fcs) {
    if (src_len - ip < uint64_t(fcs_bytes)) return false;
    for (int i = 0; i < fcs_bytes; i++)
      content_size |= uint64_t(src[ip + i]) << (8 * i);
    if (fcs_bytes == 2) content_size += 256;
    ip += uint64_t(fcs_bytes);
    if (content_size > dst_len - frame_base) return false;
  }
  ctx->rep[0] = 1;
  ctx->rep[1] = 4;
  ctx->rep[2] = 8;
  ctx->have_huf = ctx->have_ll = ctx->have_of = ctx->have_ml = false;
  bool last = false;
  while (!last) {
    if (src_len - ip < 3) return false;
    uint32_t bh = src[ip] | (uint32_t(src[ip + 1]) << 8) |
                  (uint32_t(src[ip + 2]) << 16);
    ip += 3;
    last = (bh & 1) != 0;
    int btype = (bh >> 1) & 3;
    uint64_t bsize = bh >> 3;
    if (btype == 0) {  // raw
      if (src_len - ip < bsize || dst_len - d < bsize) return false;
      std::memcpy(dst + d, src + ip, size_t(bsize));
      ip += bsize;
      d += bsize;
    } else if (btype == 1) {  // RLE
      if (src_len - ip < 1 || dst_len - d < bsize) return false;
      std::memset(dst + d, src[ip], size_t(bsize));
      ip += 1;
      d += bsize;
    } else if (btype == 2) {  // compressed
      if (bsize < 1 || src_len - ip < bsize) return false;
      uint64_t lit_consumed = 0;
      if (!zstd_literals(ctx, src + ip, bsize, &lit_consumed)) return false;
      if (lit_consumed > bsize) return false;
      if (!zstd_sequences(ctx, src + ip + lit_consumed, bsize - lit_consumed,
                          dst, dst_len, &d, frame_base))
        return false;
      ip += bsize;
    } else {
      return false;  // reserved block type
    }
  }
  if (has_checksum) {
    if (src_len - ip < 4) return false;
    ip += 4;  // xxhash not verified; bounds are the contract here
  }
  if (have_fcs && d - frame_base != content_size) return false;
  *ip_io = ip;
  *d_io = d;
  return true;
}

bool zstd_uncompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                     uint64_t dst_len) {
  ZstdCtx ctx;
  uint64_t ip = 0, d = 0;
  while (ip < src_len) {
    if (src_len - ip < 4) return false;
    uint32_t magic = src[ip] | (uint32_t(src[ip + 1]) << 8) |
                     (uint32_t(src[ip + 2]) << 16) |
                     (uint32_t(src[ip + 3]) << 24);
    ip += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (src_len - ip < 4) return false;
      uint64_t fsize = src[ip] | (uint32_t(src[ip + 1]) << 8) |
                       (uint32_t(src[ip + 2]) << 16) |
                       (uint32_t(src[ip + 3]) << 24);
      ip += 4;
      if (src_len - ip < fsize) return false;
      ip += fsize;
      continue;
    }
    if (magic != 0xFD2FB528u) return false;
    if (!zstd_frame(&ctx, src, src_len, &ip, dst, dst_len, &d)) return false;
  }
  return d == dst_len;
}

// LZ4 raw block. `hist_base` bounds how far back matches may reach (0 when
// the caller's earlier output is legal history, the block start otherwise).
bool lz4_block_uncompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                          uint64_t dst_cap, uint64_t* d_io, uint64_t hist_base) {
  uint64_t s = 0, d = *d_io;
  while (s < src_len) {
    uint32_t token = src[s++];
    uint64_t lit = token >> 4;
    if (lit == 15) {
      while (true) {
        if (s >= src_len) return false;  // unterminated length extension
        uint32_t b = src[s++];
        lit += b;
        if (b != 255) break;
      }
    }
    if (src_len - s < lit || dst_cap - d < lit) return false;
    std::memcpy(dst + d, src + s, size_t(lit));
    s += lit;
    d += lit;
    if (s == src_len) break;  // final sequence carries literals only
    if (src_len - s < 2) return false;
    uint64_t offset = src[s] | (uint64_t(src[s + 1]) << 8);
    s += 2;
    if (offset == 0 || offset > d - hist_base) return false;
    uint64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      while (true) {
        if (s >= src_len) return false;
        uint32_t b = src[s++];
        mlen += b;
        if (b != 255) break;
      }
    }
    if (dst_cap - d < mlen) return false;
    for (uint64_t i = 0; i < mlen; i++) dst[d + i] = dst[d + i - offset];
    d += mlen;
  }
  *d_io = d;
  return true;
}

bool lz4_frame_uncompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                          uint64_t dst_len) {
  if (src_len < 7) return false;
  uint32_t magic = src[0] | (uint32_t(src[1]) << 8) | (uint32_t(src[2]) << 16) |
                   (uint32_t(src[3]) << 24);
  if (magic != 0x184D2204u) return false;
  uint64_t ip = 4;
  uint32_t flg = src[ip], bd = src[ip + 1];
  ip += 2;
  if (((flg >> 6) & 3) != 1) return false;  // version must be 01
  if (flg & 0x02) return false;             // reserved FLG bit
  if (flg & 0x01) return false;             // dictionaries unsupported
  bool b_checksum = (flg & 0x10) != 0;
  bool c_size = (flg & 0x08) != 0;
  bool c_checksum = (flg & 0x04) != 0;
  if (bd & 0x8F) return false;  // reserved BD bits
  if (c_size) {
    if (src_len - ip < 8) return false;
    uint64_t csz = 0;
    for (int i = 0; i < 8; i++) csz |= uint64_t(src[ip + i]) << (8 * i);
    ip += 8;
    if (csz != dst_len) return false;
  }
  if (src_len - ip < 1) return false;
  ip += 1;  // header-checksum byte (not verified)
  uint64_t d = 0;
  while (true) {
    if (src_len - ip < 4) return false;
    uint32_t bsz = src[ip] | (uint32_t(src[ip + 1]) << 8) |
                   (uint32_t(src[ip + 2]) << 16) | (uint32_t(src[ip + 3]) << 24);
    ip += 4;
    if (bsz == 0) break;  // EndMark
    bool stored = (bsz & 0x80000000u) != 0;
    uint64_t blen = bsz & 0x7FFFFFFFu;
    if (src_len - ip < blen) return false;
    if (stored) {
      if (dst_len - d < blen) return false;
      std::memcpy(dst + d, src + ip, size_t(blen));
      d += blen;
    } else {
      if (!lz4_block_uncompress(src + ip, blen, dst, dst_len, &d, 0))
        return false;
    }
    ip += blen;
    if (b_checksum) {
      if (src_len - ip < 4) return false;
      ip += 4;
    }
  }
  if (c_checksum) {
    if (src_len - ip < 4) return false;
    ip += 4;
  }
  return d == dst_len;
}

// hadoop-framed LZ4 (what parquet's legacy LZ4 codec writes): repeated
// [u32 BE decompressed size][u32 BE compressed size][raw block]
bool lz4_hadoop_uncompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                           uint64_t dst_len) {
  uint64_t ip = 0, d = 0;
  while (ip < src_len) {
    if (src_len - ip < 8) return false;
    uint64_t want = (uint64_t(src[ip]) << 24) | (uint64_t(src[ip + 1]) << 16) |
                    (uint64_t(src[ip + 2]) << 8) | uint64_t(src[ip + 3]);
    uint64_t clen = (uint64_t(src[ip + 4]) << 24) |
                    (uint64_t(src[ip + 5]) << 16) |
                    (uint64_t(src[ip + 6]) << 8) | uint64_t(src[ip + 7]);
    ip += 8;
    if (src_len - ip < clen) return false;
    if (dst_len - d < want) return false;
    uint64_t d0 = d;
    if (!lz4_block_uncompress(src + ip, clen, dst, d0 + want, &d, d0))
      return false;
    if (d - d0 != want) return false;
    ip += clen;
  }
  return d == dst_len;
}

// 'LZ4' parquet metadata is ambiguous in the wild: try hadoop framing, then
// the lz4 frame format, then a bare raw block
bool lz4_auto_uncompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                         uint64_t dst_len) {
  if (lz4_hadoop_uncompress(src, src_len, dst, dst_len)) return true;
  if (src_len >= 4) {
    uint32_t magic = src[0] | (uint32_t(src[1]) << 8) |
                     (uint32_t(src[2]) << 16) | (uint32_t(src[3]) << 24);
    if (magic == 0x184D2204u)
      return lz4_frame_uncompress(src, src_len, dst, dst_len);
  }
  uint64_t d = 0;
  return lz4_block_uncompress(src, src_len, dst, dst_len, &d, 0) &&
         d == dst_len;
}

bool decompress_page(int codec, const uint8_t* src, uint64_t src_len,
                     uint8_t* dst, uint64_t dst_len) {
  if (codec == kCodecSnappy) return snappy_uncompress(src, src_len, dst, dst_len);
  if (codec == kCodecZstd) return zstd_uncompress(src, src_len, dst, dst_len);
  if (codec == kCodecLz4Raw) {
    uint64_t d = 0;
    return lz4_block_uncompress(src, src_len, dst, dst_len, &d, 0) &&
           d == dst_len;
  }
  if (codec == kCodecLz4) return lz4_auto_uncompress(src, src_len, dst, dst_len);
  return false;
}

}  // namespace

// one column of the fused batch; mirrored field-for-field by the
// ctypes.Structure in native/fused.py (the batch-buffer ABI). File scope (not
// the anonymous namespace): the extern "C" entry point takes it by pointer.
struct FusedCol {
  const uint8_t* chunk;   // column chunk bytes (dictionary page first)
  uint64_t chunk_len;
  uint8_t* out;           // destination region inside the batch buffer
  uint64_t out_cap;       // bounds: the native side never writes past this
  uint8_t* aux_buf;       // small per-column side buffer (npy header copy)
  uint64_t aux_cap;
  int64_t expected_rows;
  int32_t mode;           // kMode*
  int32_t codec;          // kCodec*
  int32_t itemsize;       // kModeFixed: value byte width (FLBA width for FLBA)
  int32_t has_def_levels; // OPTIONAL chunk PROVEN null-free: skip RLE block
  int32_t strip_npy;      // kModeBinaryRaw: strip identical np.save headers
  int32_t img_w, img_h, img_c;  // kModeBinaryImg: expected decoded dims
  int32_t img_threads;
  int32_t status;         // out: kCol*
  uint64_t out_used;      // out: bytes written into `out`
  uint64_t aux0;          // out: raw: per-cell payload len; img: row bytes
  uint64_t aux1;          // out: raw: npy header len in aux_buf
};

// one native predicate clause; mirrored field-for-field by the
// ctypes.Structure in native/fused.py. `col` indexes the pred_cols array of
// pstpu_read_fused_pred; operands are little-endian scalars of the column's
// physical width, and range bounds are packed [lo][hi] in `values`.
struct FusedPred {
  const uint8_t* values;  // kPredIn: `count` packed operands; kPredRange: [lo][hi]
  uint64_t values_cap;    // bounds: operand reads never pass this
  int64_t count;          // kPredIn: number of operands
  int32_t col;
  int32_t op;             // kPred* op
  int32_t dtype;          // kPred* physical dtype
  int32_t negate;
  int32_t has_lo, has_hi;
  int32_t lo_incl, hi_incl;
  int32_t status;         // out: kCol* status of the clause's column
  int32_t pages_skipped;  // out: stat-skipped pages of the clause's column
};

namespace {

// batched image-codec entry points (image_codec.cpp), passed as pointers so
// this kernel needs no link-time dependency on the optional image library
using ImgProbeFn = long long (*)(long long, void**, unsigned long long*,
                                 int32_t*, int32_t, int32_t);
using ImgDecodeFn = long long (*)(long long, void**, unsigned long long*,
                                  void**, int32_t*, int, int32_t, int32_t);

struct PageRec {
  int32_t encoding;
  int64_t num_values;
  uint64_t body_off;   // page body offset within the chunk (possibly compressed)
  uint64_t body_len;   // compressed size
  uint64_t plain_len;  // uncompressed size
  bool is_dict;
  // DATA_PAGE_V2: rep+def levels are an uncompressed prefix of the body
  // (skipped by explicit length — num_nulls == 0 is checked at scan time, so
  // the all-ones def levels carry no information), and `v2_compressed`
  // scopes the chunk codec to the data region alone
  bool is_v2 = false;
  bool v2_compressed = false;
  uint64_t levels_len = 0;
  // page-header statistics (pointers into the chunk's header bytes, which
  // outlive the PageRec within a fused call; -1 length = stat absent)
  const uint8_t* stat_min = nullptr;
  const uint8_t* stat_max = nullptr;
  int64_t stat_min_len = -1;
  int64_t stat_max_len = -1;
  int64_t stat_null_count = -1;
};

int scan_fused_pages(const FusedCol& c, int max_pages, std::vector<PageRec>* pages) {
  if (c.codec < kCodecUncompressed || c.codec > kCodecLz4) return kColCompressed;
  uint64_t pos = 0;
  while (pos < c.chunk_len) {
    TReader r{c.chunk + pos, c.chunk + c.chunk_len};
    PageInfo info;
    if (!parse_page_header(r, &info)) return kColParse;
    if (info.compressed_size < 0 || info.uncompressed_size < 0) return kColParse;
    // cap the per-page scratch a hostile uncompressed_size can demand
    if (info.uncompressed_size > (int64_t(1) << 30)) return kColParse;
    const uint64_t body_off = pos + info.header_len;
    const uint64_t page_end = body_off + uint64_t(info.compressed_size);
    if (page_end > c.chunk_len || page_end <= pos) return kColBounds;
    if (c.codec == kCodecUncompressed &&
        info.compressed_size != info.uncompressed_size) {
      return kColCompressed;
    }
    PageRec rec;
    rec.body_off = body_off;
    rec.body_len = uint64_t(info.compressed_size);
    rec.plain_len = uint64_t(info.uncompressed_size);
    rec.stat_min = info.stat_min;
    rec.stat_max = info.stat_max;
    rec.stat_min_len = info.stat_min_len;
    rec.stat_max_len = info.stat_max_len;
    rec.stat_null_count = info.stat_null_count;
    if (info.page_type == 2) {  // dictionary page
      if (!pages->empty()) return kColParse;  // must precede the data pages
      if (info.dict_encoding != 0 && info.dict_encoding != 2) return kColEncoding;
      if (info.dict_num_values < 0) return kColParse;
      rec.encoding = 0;
      rec.num_values = info.dict_num_values;
      rec.is_dict = true;
    } else if (info.page_type == 0) {  // data page v1
      if (info.encoding != 0 && info.encoding != 2 && info.encoding != 8) {
        return kColEncoding;
      }
      if (c.has_def_levels && info.def_level_encoding != 3) return kColDefLevels;
      if (info.num_values < 0) return kColParse;
      rec.encoding = info.encoding;
      rec.num_values = info.num_values;
      rec.is_dict = false;
    } else if (info.page_type == 3) {  // data page v2
      if (info.encoding != 0 && info.encoding != 2 && info.encoding != 8) {
        return kColEncoding;
      }
      if (info.num_values < 0 || info.v2_def_len < 0 || info.v2_rep_len < 0) {
        return kColParse;
      }
      // v2 headers state num_nulls explicitly: only a proven-null-free page
      // fuses (the v1 path needs chunk statistics for the same proof), and a
      // flat column's rep levels are zero-length by construction
      if (info.v2_num_nulls != 0) return kColDefLevels;
      const uint64_t levels = uint64_t(info.v2_def_len) + uint64_t(info.v2_rep_len);
      if (levels > rec.body_len || levels > rec.plain_len) return kColDefLevels;
      rec.encoding = info.encoding;
      rec.num_values = info.num_values;
      rec.is_dict = false;
      rec.is_v2 = true;
      rec.v2_compressed = info.v2_is_compressed != 0;
      rec.levels_len = levels;
    } else {
      return kColPageType;  // index / unknown pages: Arrow path
    }
    if (int(pages->size()) >= max_pages) return kColPageCap;
    pages->push_back(rec);
    pos = page_end;
  }
  return kColOk;
}

// Uncompressed VALUES region of one page: decompresses into `scratch` when the
// chunk codec is snappy/zstd/lz4, then skips the RLE def-levels block when
// present. The returned pointer aliases either the chunk or `scratch` — the
// caller keeps `scratch` alive while the values are in use.
int page_values(const FusedCol& c, const PageRec& pg, std::vector<uint8_t>* scratch,
                const uint8_t** vals, uint64_t* vlen) {
  const uint8_t* base = c.chunk + pg.body_off;
  uint64_t len = pg.body_len;
  if (pg.is_v2) {
    // v2 layout: [rep levels][def levels] UNCOMPRESSED, then the data region
    // (compressed only when the header's is_compressed flag says so). The
    // level lengths were bounds-checked against body/plain size at scan time.
    const uint8_t* data = base + pg.levels_len;
    const uint64_t data_len = len - pg.levels_len;
    const uint64_t plain_data = pg.plain_len - pg.levels_len;
    if (pg.v2_compressed && c.codec != kCodecUncompressed) {
      scratch->resize(size_t(plain_data));
      if (!decompress_page(c.codec, data, data_len, scratch->data(), plain_data)) {
        return kColParse;
      }
      *vals = scratch->data();
      *vlen = plain_data;
      return kColOk;
    }
    *vals = data;
    *vlen = data_len;
    return kColOk;
  }
  if (c.codec != kCodecUncompressed) {
    scratch->resize(size_t(pg.plain_len));
    if (!decompress_page(c.codec, base, len, scratch->data(), pg.plain_len)) {
      return kColParse;
    }
    base = scratch->data();
    len = pg.plain_len;
  }
  if (!pg.is_dict && c.has_def_levels) {
    if (len < 4) return kColDefLevels;
    uint32_t def_len = 0;
    std::memcpy(&def_len, base, 4);  // little-endian host
    if (uint64_t(def_len) + 4 > len) return kColDefLevels;
    base += 4 + def_len;
    len -= 4 + def_len;
  }
  *vals = base;
  *vlen = len;
  return kColOk;
}

int decode_fixed(FusedCol* c, const std::vector<PageRec>& pages) {
  const uint64_t w = uint64_t(c->itemsize);
  if (w == 0 || w > (64u << 20)) return kColParse;
  std::vector<uint8_t> dict_store;       // owns decompressed dictionary values
  const uint8_t* dict_vals = nullptr;
  uint64_t n_dict = 0;
  std::vector<uint8_t> scratch;
  std::vector<uint32_t> idx;
  uint64_t written = 0;
  int64_t rows = 0;
  for (const PageRec& pg : pages) {
    const uint8_t* vals = nullptr;
    uint64_t vlen = 0;
    if (pg.is_dict) {
      int rc = page_values(*c, pg, &dict_store, &vals, &vlen);
      if (rc != kColOk) return rc;
      // division form: num_values * w would wrap for a corrupt huge count
      if (uint64_t(pg.num_values) > vlen / w) return kColDict;
      if (c->codec == kCodecUncompressed) {
        // values point into the chunk; keep them there (no copy needed)
        dict_vals = vals;
      } else {
        dict_vals = dict_store.data();  // scratch persists for the column
      }
      n_dict = uint64_t(pg.num_values);
      continue;
    }
    int rc = page_values(*c, pg, &scratch, &vals, &vlen);
    if (rc != kColOk) return rc;
    if (uint64_t(pg.num_values) > c->out_cap / w) return kColBounds;
    const uint64_t need = uint64_t(pg.num_values) * w;
    if (written + need > c->out_cap) return kColBounds;
    if (pg.encoding == 0) {  // PLAIN: the values region IS the rows
      if (need > vlen) return kColBounds;
      std::memcpy(c->out + written, vals, need);
    } else {  // PLAIN_DICTIONARY / RLE_DICTIONARY indices
      if (dict_vals == nullptr) return kColDict;
      if (vlen < 1) return kColParse;
      const int bw = vals[0];
      if (!decode_hybrid(vals + 1, vals + vlen, bw, pg.num_values, &idx)) {
        return kColParse;
      }
      uint8_t* dst = c->out + written;
      for (int64_t i = 0; i < pg.num_values; i++) {
        const uint32_t k = idx[size_t(i)];
        if (k >= n_dict) return kColDict;
        std::memcpy(dst + uint64_t(i) * w, dict_vals + uint64_t(k) * w, w);
      }
    }
    written += need;
    rows += pg.num_values;
  }
  if (rows != c->expected_rows) return kColRows;
  c->out_used = written;
  return kColOk;
}

// Collect the byte-array cells of a BYTE_ARRAY chunk (PLAIN length-prefixed
// values, or dictionary indices into length-prefixed dictionary entries).
// Cell pointers alias the chunk or the scratch vectors pushed onto
// `scratches` — which the caller must keep alive while the cells are in use.
int collect_cells(const FusedCol& c, const std::vector<PageRec>& pages,
                  std::vector<std::pair<const uint8_t*, uint64_t>>* cells,
                  std::vector<std::vector<uint8_t>>* scratches) {
  std::vector<std::pair<const uint8_t*, uint64_t>> dict_entries;
  std::vector<uint32_t> idx;
  for (const PageRec& pg : pages) {
    scratches->emplace_back();
    const uint8_t* vals = nullptr;
    uint64_t vlen = 0;
    int rc = page_values(c, pg, &scratches->back(), &vals, &vlen);
    if (rc != kColOk) return rc;
    if (pg.is_dict) {
      dict_entries.clear();
      dict_entries.reserve(size_t(pg.num_values));
      uint64_t off = 0;
      for (int64_t i = 0; i < pg.num_values; i++) {
        if (off + 4 > vlen) return kColDict;
        uint32_t n = 0;
        std::memcpy(&n, vals + off, 4);
        off += 4;
        if (uint64_t(n) > vlen - off) return kColDict;
        dict_entries.emplace_back(vals + off, uint64_t(n));
        off += n;
      }
      continue;
    }
    if (pg.encoding == 0) {  // PLAIN: <u32 len><bytes> per value
      uint64_t off = 0;
      for (int64_t i = 0; i < pg.num_values; i++) {
        if (off + 4 > vlen) return kColBounds;
        uint32_t n = 0;
        std::memcpy(&n, vals + off, 4);
        off += 4;
        if (uint64_t(n) > vlen - off) return kColBounds;
        cells->emplace_back(vals + off, uint64_t(n));
        off += n;
      }
    } else {  // dictionary indices
      if (dict_entries.empty() && pg.num_values > 0) return kColDict;
      if (vlen < 1) return kColParse;
      if (!decode_hybrid(vals + 1, vals + vlen, vals[0], pg.num_values, &idx)) {
        return kColParse;
      }
      for (int64_t i = 0; i < pg.num_values; i++) {
        const uint32_t k = idx[size_t(i)];
        if (k >= dict_entries.size()) return kColDict;
        cells->push_back(dict_entries[size_t(k)]);
      }
    }
  }
  if (int64_t(cells->size()) != c.expected_rows) return kColRows;
  return kColOk;
}

// np.save header span of one cell: magic + version + 2/4-byte header length.
// Returns 0 when the cell is not a standard v1/v2 npy payload.
uint64_t npy_header_len(const uint8_t* p, uint64_t n) {
  static const uint8_t kMagic[6] = {0x93, 'N', 'U', 'M', 'P', 'Y'};
  if (n < 12 || std::memcmp(p, kMagic, 6) != 0) return 0;
  uint64_t data_off;
  if (p[6] == 1) {
    data_off = 10 + (uint64_t(p[8]) | (uint64_t(p[9]) << 8));
  } else if (p[6] == 2) {
    uint32_t hl = 0;
    std::memcpy(&hl, p + 8, 4);
    data_off = 12 + uint64_t(hl);
  } else {
    return 0;
  }
  return data_off <= n ? data_off : 0;
}

// Collate pre-collected byte-array cells (all rows, or the predicate-selected
// subset) into the column's output region; the first cell defines the npy
// header when stripping.
int decode_binary_raw_cells(
    FusedCol* c, const std::vector<std::pair<const uint8_t*, uint64_t>>& cells) {
  if (cells.empty()) return kColRows;
  const uint64_t cell_len = cells[0].second;
  uint64_t prefix = 0;
  if (c->strip_npy) {
    prefix = npy_header_len(cells[0].first, cell_len);
    if (prefix == 0) return kColNonUniform;
    if (prefix > c->aux_cap || c->aux_buf == nullptr) return kColNonUniform;
    std::memcpy(c->aux_buf, cells[0].first, prefix);
    c->aux1 = prefix;
  }
  const uint64_t payload = cell_len - prefix;
  uint64_t written = 0;
  for (const auto& cell : cells) {
    if (cell.second != cell_len) return kColNonUniform;
    if (prefix != 0 && std::memcmp(cell.first, cells[0].first, prefix) != 0) {
      return kColNonUniform;  // mixed shapes/dtypes within the chunk
    }
    if (written + payload > c->out_cap) return kColBounds;
    std::memcpy(c->out + written, cell.first + prefix, payload);
    written += payload;
  }
  c->aux0 = payload;
  c->out_used = written;
  return kColOk;
}

int decode_binary_raw(FusedCol* c, const std::vector<PageRec>& pages) {
  std::vector<std::pair<const uint8_t*, uint64_t>> cells;
  std::vector<std::vector<uint8_t>> scratches;
  int rc = collect_cells(*c, pages, &cells, &scratches);
  if (rc != kColOk) return rc;
  return decode_binary_raw_cells(c, cells);
}

int decode_binary_img_cells(
    FusedCol* c, const std::vector<std::pair<const uint8_t*, uint64_t>>& cells,
    ImgProbeFn probe, ImgDecodeFn decode) {
  if (probe == nullptr || decode == nullptr) return kColImgProbe;
  const long long n = (long long)cells.size();
  if (n == 0) return kColRows;
  const size_t un = size_t(n);
  std::vector<void*> ptrs(un);
  std::vector<unsigned long long> lens(un);
  for (size_t i = 0; i < un; i++) {
    ptrs[i] = const_cast<uint8_t*>(cells[i].first);
    lens[i] = cells[i].second;
  }
  std::vector<int32_t> infos(un * 4);
  if (probe(n, ptrs.data(), lens.data(), infos.data(), 0, 0) != -1) {
    return kColImgProbe;
  }
  const uint64_t row_bytes =
      uint64_t(c->img_h) * uint64_t(c->img_w) * uint64_t(c->img_c);
  for (long long i = 0; i < n; i++) {
    const int32_t* info = &infos[size_t(i) * 4];  // (w, h, c, depth)
    if (info[0] != c->img_w || info[1] != c->img_h || info[2] != c->img_c ||
        info[3] != 8) {
      return kColImgDims;
    }
  }
  // division form: n * row_bytes would wrap for corrupt huge dimensions,
  // sneaking a tiny product past the capacity check (PT903)
  if (row_bytes == 0 || uint64_t(n) > c->out_cap / row_bytes) return kColBounds;
  std::vector<void*> outs(un);
  for (size_t i = 0; i < un; i++) outs[i] = c->out + uint64_t(i) * row_bytes;
  const int threads = c->img_threads > 0 ? c->img_threads : 1;
  if (decode(n, ptrs.data(), lens.data(), outs.data(), infos.data(), threads,
             0, 0) != -1) {
    return kColImgDecode;
  }
  c->aux0 = row_bytes;
  c->out_used = uint64_t(n) * row_bytes;
  return kColOk;
}

int decode_binary_img(FusedCol* c, const std::vector<PageRec>& pages,
                      ImgProbeFn probe, ImgDecodeFn decode) {
  std::vector<std::pair<const uint8_t*, uint64_t>> cells;
  std::vector<std::vector<uint8_t>> scratches;
  int rc = collect_cells(*c, pages, &cells, &scratches);
  if (rc != kColOk) return rc;
  return decode_binary_img_cells(c, cells, probe, decode);
}

void decode_fused_column(FusedCol* c, int max_pages, ImgProbeFn probe,
                         ImgDecodeFn decode) {
  try {
    if (c->chunk == nullptr || c->out == nullptr || c->expected_rows < 0) {
      c->status = kColInternal;
      return;
    }
    std::vector<PageRec> pages;
    int rc = scan_fused_pages(*c, max_pages, &pages);
    if (rc == kColOk) {
      switch (c->mode) {
        case kModeFixed: rc = decode_fixed(c, pages); break;
        case kModeBinaryRaw: rc = decode_binary_raw(c, pages); break;
        case kModeBinaryImg: rc = decode_binary_img(c, pages, probe, decode); break;
        default: rc = kColInternal;
      }
    }
    c->status = rc;
  } catch (...) {  // bad_alloc etc.: fail the column, never the process
    c->status = kColInternal;
  }
}

// ---------------------------------------------------------------------------
// native predicate pushdown: evaluate equality/set/range clauses against the
// decoded predicate columns, emit a row-selection bitmap, and gate the output
// collation on it — all inside the same GIL-released call.

enum { kPredIn = 0, kPredRange = 1 };
enum { kPredI32 = 0, kPredI64 = 1, kPredU32 = 2, kPredU64 = 3,
       kPredF32 = 4, kPredF64 = 5 };

inline int pred_width(int dtype) {
  switch (dtype) {
    case kPredI32: case kPredU32: case kPredF32: return 4;
    case kPredI64: case kPredU64: case kPredF64: return 8;
    default: return 0;
  }
}

// -1/0/+1 three-way compare of two little-endian scalars; -2 when either
// float operand is NaN (float order is partial — callers must not trust it)
int pred_cmp(int dtype, const uint8_t* a, const uint8_t* b) {
  switch (dtype) {
    case kPredI32: {
      int32_t x, y;
      std::memcpy(&x, a, 4);
      std::memcpy(&y, b, 4);
      return x < y ? -1 : (x > y ? 1 : 0);
    }
    case kPredI64: {
      int64_t x, y;
      std::memcpy(&x, a, 8);
      std::memcpy(&y, b, 8);
      return x < y ? -1 : (x > y ? 1 : 0);
    }
    case kPredU32: {
      uint32_t x, y;
      std::memcpy(&x, a, 4);
      std::memcpy(&y, b, 4);
      return x < y ? -1 : (x > y ? 1 : 0);
    }
    case kPredU64: {
      uint64_t x, y;
      std::memcpy(&x, a, 8);
      std::memcpy(&y, b, 8);
      return x < y ? -1 : (x > y ? 1 : 0);
    }
    case kPredF32: {
      float x, y;
      std::memcpy(&x, a, 4);
      std::memcpy(&y, b, 4);
      if (x != x || y != y) return -2;
      return x < y ? -1 : (x > y ? 1 : 0);
    }
    case kPredF64: {
      double x, y;
      std::memcpy(&x, a, 8);
      std::memcpy(&y, b, 8);
      if (x != x || y != y) return -2;
      return x < y ? -1 : (x > y ? 1 : 0);
    }
  }
  return -2;
}

// does one decoded value satisfy the clause? (NaN matches nothing before
// negation — the vectorized numpy fallback behaves identically)
bool pred_match_value(const FusedPred& p, const uint8_t* v, int w) {
  bool m;
  if (p.op == kPredIn) {
    m = false;
    for (int64_t i = 0; i < p.count; i++) {
      const uint8_t* e = p.values + uint64_t(i) * uint64_t(w);
      if (pred_cmp(p.dtype, v, e) == 0) { m = true; break; }
    }
  } else {
    m = true;
    if (p.has_lo) {
      const int c = pred_cmp(p.dtype, v, p.values);
      if (c == -2 || c < 0 || (c == 0 && !p.lo_incl)) m = false;
    }
    if (m && p.has_hi) {
      const int c = pred_cmp(p.dtype, v, p.values + uint64_t(w));
      if (c == -2 || c > 0 || (c == 0 && !p.hi_incl)) m = false;
    }
  }
  return p.negate ? !m : m;
}

// page-stat verdict for one clause: 1 = every row matches, -1 = none does,
// 0 = undecided (decode required). Sound only because fused qualification
// already proved the chunk null-free; an explicit positive null_count (or
// absent/NaN/odd-width min-max) always degrades to "decode everything".
int pred_stats_verdict(const FusedPred& p, const PageRec& pg, int w) {
  if (pg.stat_null_count > 0) return 0;
  if (pg.stat_min == nullptr || pg.stat_max == nullptr) return 0;
  if (pg.stat_min_len != w || pg.stat_max_len != w) return 0;
  if (pred_cmp(p.dtype, pg.stat_min, pg.stat_max) == -2) return 0;
  int v = 0;
  if (p.op == kPredRange) {
    bool none = false, all = true;
    if (p.has_lo) {
      const int cmax = pred_cmp(p.dtype, pg.stat_max, p.values);
      const int cmin = pred_cmp(p.dtype, pg.stat_min, p.values);
      if (cmax == -2 || cmin == -2) return 0;
      if (cmax < 0 || (cmax == 0 && !p.lo_incl)) none = true;
      if (cmin < 0 || (cmin == 0 && !p.lo_incl)) all = false;
    }
    if (p.has_hi) {
      const int cmin = pred_cmp(p.dtype, pg.stat_min, p.values + uint64_t(w));
      const int cmax = pred_cmp(p.dtype, pg.stat_max, p.values + uint64_t(w));
      if (cmin == -2 || cmax == -2) return 0;
      if (cmin > 0 || (cmin == 0 && !p.hi_incl)) none = true;
      if (cmax > 0 || (cmax == 0 && !p.hi_incl)) all = false;
    }
    v = none ? -1 : (all ? 1 : 0);
  } else {  // kPredIn
    bool any_inside = false;
    for (int64_t i = 0; i < p.count; i++) {
      const uint8_t* e = p.values + uint64_t(i) * uint64_t(w);
      const int cl = pred_cmp(p.dtype, e, pg.stat_min);
      const int ch = pred_cmp(p.dtype, e, pg.stat_max);
      if (cl == -2 || ch == -2) continue;  // a NaN operand matches nothing
      if (cl >= 0 && ch <= 0) { any_inside = true; break; }
    }
    if (!any_inside) {
      v = -1;
    } else if (pred_cmp(p.dtype, pg.stat_min, pg.stat_max) == 0) {
      v = 1;  // single-valued page whose value is in the set
    }
  }
  return p.negate ? -v : v;
}

inline bool sel_get(const uint8_t* sel, uint64_t i) {
  return (sel[i >> 3] >> (i & 7)) & 1;
}
inline void sel_clear(uint8_t* sel, uint64_t i) {
  sel[i >> 3] = uint8_t(sel[i >> 3] & ~(uint32_t(1) << (i & 7)));
}
inline bool sel_any(const uint8_t* sel, uint64_t row0, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) {
    if (sel_get(sel, row0 + i)) return true;
  }
  return false;
}

// Phase 1 over one predicate column: page row-spans come from the cumulative
// value counts; pages the statistics prove irrelevant (or that an earlier
// clause already fully deselected) skip decode entirely.
int eval_pred_column(FusedCol* pc, const std::vector<FusedPred*>& clauses,
                     uint8_t* sel, int max_pages, long long* pages_skipped) {
  if (clauses.empty()) return kColInternal;
  const int w = pred_width(clauses[0]->dtype);
  for (const FusedPred* p : clauses) {
    if (pred_width(p->dtype) != w) return kColParse;
  }
  if (w == 0 || pc->mode != kModeFixed || pc->itemsize != w) return kColParse;
  std::vector<PageRec> pages;
  int rc = scan_fused_pages(*pc, max_pages, &pages);
  if (rc != kColOk) return rc;
  std::vector<uint8_t> dict_store, scratch;
  std::vector<uint32_t> idx;
  const uint8_t* dict_vals = nullptr;
  uint64_t n_dict = 0;
  uint64_t row0 = 0;
  const uint64_t uw = uint64_t(w);
  for (const PageRec& pg : pages) {
    const uint8_t* vals = nullptr;
    uint64_t vlen = 0;
    if (pg.is_dict) {
      rc = page_values(*pc, pg, &dict_store, &vals, &vlen);
      if (rc != kColOk) return rc;
      if (uint64_t(pg.num_values) > vlen / uw) return kColDict;
      dict_vals = pc->codec == kCodecUncompressed ? vals : dict_store.data();
      n_dict = uint64_t(pg.num_values);
      continue;
    }
    const uint64_t nv = uint64_t(pg.num_values);
    if (row0 + nv > uint64_t(pc->expected_rows)) return kColRows;
    bool page_none = false, page_all = true;
    for (const FusedPred* p : clauses) {
      const int v = pred_stats_verdict(*p, pg, w);
      if (v < 0) page_none = true;
      if (v <= 0) page_all = false;
    }
    if (page_none) {
      for (uint64_t i = 0; i < nv; i++) sel_clear(sel, row0 + i);
      (*pages_skipped)++;
      row0 += nv;
      continue;
    }
    if (page_all || !sel_any(sel, row0, nv)) {
      (*pages_skipped)++;
      row0 += nv;
      continue;
    }
    rc = page_values(*pc, pg, &scratch, &vals, &vlen);
    if (rc != kColOk) return rc;
    if (pg.encoding == 0) {  // PLAIN
      if (nv > vlen / uw) return kColBounds;
      for (uint64_t i = 0; i < nv; i++) {
        if (!sel_get(sel, row0 + i)) continue;
        const uint8_t* v = vals + i * uw;
        for (const FusedPred* p : clauses) {
          if (!pred_match_value(*p, v, w)) { sel_clear(sel, row0 + i); break; }
        }
      }
    } else {  // dictionary indices
      if (dict_vals == nullptr) return kColDict;
      if (vlen < 1) return kColParse;
      if (!decode_hybrid(vals + 1, vals + vlen, vals[0], pg.num_values, &idx)) {
        return kColParse;
      }
      for (uint64_t i = 0; i < nv; i++) {
        if (!sel_get(sel, row0 + i)) continue;
        const uint32_t k = idx[size_t(i)];
        if (k >= n_dict) return kColDict;
        const uint8_t* v = dict_vals + uint64_t(k) * uw;
        for (const FusedPred* p : clauses) {
          if (!pred_match_value(*p, v, w)) { sel_clear(sel, row0 + i); break; }
        }
      }
    }
    row0 += nv;
  }
  if (row0 != uint64_t(pc->expected_rows)) return kColRows;
  return kColOk;
}

// Phase 2 fixed-width gather: only the selected rows reach the output region;
// pages with no selected rows skip decompression entirely.
int decode_fixed_gather(FusedCol* c, const std::vector<PageRec>& pages,
                        const uint8_t* sel, long long n_selected,
                        long long* pages_skipped) {
  const uint64_t w = uint64_t(c->itemsize);
  if (w == 0 || w > (64u << 20)) return kColParse;
  std::vector<uint8_t> dict_store, scratch;
  std::vector<uint32_t> idx;
  const uint8_t* dict_vals = nullptr;
  uint64_t n_dict = 0;
  uint64_t written = 0;
  uint64_t row0 = 0;
  for (const PageRec& pg : pages) {
    const uint8_t* vals = nullptr;
    uint64_t vlen = 0;
    if (pg.is_dict) {
      int rc = page_values(*c, pg, &dict_store, &vals, &vlen);
      if (rc != kColOk) return rc;
      const uint64_t dict_n = uint64_t(pg.num_values);
      if (dict_n > vlen / w) return kColDict;
      dict_vals = c->codec == kCodecUncompressed ? vals : dict_store.data();
      n_dict = dict_n;
      continue;
    }
    const uint64_t nv = uint64_t(pg.num_values);
    if (row0 + nv > uint64_t(c->expected_rows)) return kColRows;
    if (!sel_any(sel, row0, nv)) {
      (*pages_skipped)++;
      row0 += nv;
      continue;
    }
    int rc = page_values(*c, pg, &scratch, &vals, &vlen);
    if (rc != kColOk) return rc;
    if (pg.encoding == 0) {  // PLAIN
      if (nv > vlen / w) return kColBounds;
      for (uint64_t i = 0; i < nv; i++) {
        if (!sel_get(sel, row0 + i)) continue;
        if (c->out_cap - written < w) return kColBounds;
        std::memcpy(c->out + written, vals + i * w, w);
        written += w;
      }
    } else {  // dictionary indices
      if (dict_vals == nullptr) return kColDict;
      if (vlen < 1) return kColParse;
      if (!decode_hybrid(vals + 1, vals + vlen, vals[0], pg.num_values, &idx)) {
        return kColParse;
      }
      for (uint64_t i = 0; i < nv; i++) {
        if (!sel_get(sel, row0 + i)) continue;
        const uint32_t k = idx[size_t(i)];
        if (k >= n_dict) return kColDict;
        if (c->out_cap - written < w) return kColBounds;
        std::memcpy(c->out + written, dict_vals + uint64_t(k) * w, w);
        written += w;
      }
    }
    row0 += nv;
  }
  if (row0 != uint64_t(c->expected_rows)) return kColRows;
  if (written != uint64_t(n_selected) * w) return kColRows;
  c->out_used = written;
  return kColOk;
}

// Phase 2 byte-array gather: dictionary pages always decode (any row may
// reference them); data pages with no selected rows are skipped.
int collect_cells_gather(const FusedCol& c, const std::vector<PageRec>& pages,
                         const uint8_t* sel, long long n_selected,
                         std::vector<std::pair<const uint8_t*, uint64_t>>* cells,
                         std::vector<std::vector<uint8_t>>* scratches,
                         long long* pages_skipped) {
  std::vector<std::pair<const uint8_t*, uint64_t>> dict_entries;
  std::vector<uint32_t> idx;
  uint64_t row0 = 0;
  for (const PageRec& pg : pages) {
    if (pg.is_dict) {
      scratches->emplace_back();
      const uint8_t* vals = nullptr;
      uint64_t vlen = 0;
      int rc = page_values(c, pg, &scratches->back(), &vals, &vlen);
      if (rc != kColOk) return rc;
      dict_entries.clear();
      dict_entries.reserve(size_t(pg.num_values));
      uint64_t off = 0;
      for (int64_t i = 0; i < pg.num_values; i++) {
        if (off + 4 > vlen) return kColDict;
        uint32_t n = 0;
        std::memcpy(&n, vals + off, 4);
        off += 4;
        if (uint64_t(n) > vlen - off) return kColDict;
        dict_entries.emplace_back(vals + off, uint64_t(n));
        off += n;
      }
      continue;
    }
    const uint64_t nv = uint64_t(pg.num_values);
    if (row0 + nv > uint64_t(c.expected_rows)) return kColRows;
    if (!sel_any(sel, row0, nv)) {
      (*pages_skipped)++;
      row0 += nv;
      continue;
    }
    scratches->emplace_back();
    const uint8_t* vals = nullptr;
    uint64_t vlen = 0;
    int rc = page_values(c, pg, &scratches->back(), &vals, &vlen);
    if (rc != kColOk) return rc;
    if (pg.encoding == 0) {  // PLAIN: <u32 len><bytes>; walk all, keep selected
      uint64_t off = 0;
      for (uint64_t i = 0; i < nv; i++) {
        if (off + 4 > vlen) return kColBounds;
        uint32_t n = 0;
        std::memcpy(&n, vals + off, 4);
        off += 4;
        if (uint64_t(n) > vlen - off) return kColBounds;
        if (sel_get(sel, row0 + i)) cells->emplace_back(vals + off, uint64_t(n));
        off += n;
      }
    } else {  // dictionary indices
      if (dict_entries.empty() && nv > 0) return kColDict;
      if (vlen < 1) return kColParse;
      if (!decode_hybrid(vals + 1, vals + vlen, vals[0], pg.num_values, &idx)) {
        return kColParse;
      }
      for (uint64_t i = 0; i < nv; i++) {
        if (!sel_get(sel, row0 + i)) continue;
        const uint32_t k = idx[size_t(i)];
        if (k >= dict_entries.size()) return kColDict;
        cells->push_back(dict_entries[size_t(k)]);
      }
    }
    row0 += nv;
  }
  if (row0 != uint64_t(c.expected_rows)) return kColRows;
  if (int64_t(cells->size()) != int64_t(n_selected)) return kColRows;
  return kColOk;
}

void decode_fused_column_gather(FusedCol* c, const uint8_t* sel,
                                long long n_selected, int max_pages,
                                ImgProbeFn probe, ImgDecodeFn decode,
                                std::atomic<long long>* pages_skipped) {
  try {
    if (c->chunk == nullptr || c->out == nullptr || c->expected_rows < 0) {
      c->status = kColInternal;
      return;
    }
    std::vector<PageRec> pages;
    int rc = scan_fused_pages(*c, max_pages, &pages);
    long long skipped = 0;
    if (rc == kColOk && c->mode == kModeFixed) {
      rc = decode_fixed_gather(c, pages, sel, n_selected, &skipped);
    } else if (rc == kColOk &&
               (c->mode == kModeBinaryRaw || c->mode == kModeBinaryImg)) {
      std::vector<std::pair<const uint8_t*, uint64_t>> cells;
      std::vector<std::vector<uint8_t>> scratches;
      rc = collect_cells_gather(*c, pages, sel, n_selected, &cells, &scratches,
                                &skipped);
      if (rc == kColOk) {
        rc = c->mode == kModeBinaryRaw
                 ? decode_binary_raw_cells(c, cells)
                 : decode_binary_img_cells(c, cells, probe, decode);
      }
    } else if (rc == kColOk) {
      rc = kColInternal;
    }
    pages_skipped->fetch_add(skipped);
    c->status = rc;
  } catch (...) {
    c->status = kColInternal;
  }
}

}  // namespace

extern "C" {

// Decode a whole batch of column chunks into their preallocated regions of
// one contiguous batch buffer. Runs on up to `n_threads` C++ threads (the
// calling thread participates); the caller holds no GIL (ctypes releases it),
// so this is the single Python<->C transition of the batch. Returns the
// number of columns whose status != OK (callers re-read those via Arrow), or
// -1 on invalid arguments.
long long pstpu_read_fused(struct FusedCol* cols, int n_cols, int n_threads,
                           int max_pages, void* img_probe_fn, void* img_decode_fn) {
  if (cols == nullptr || n_cols < 0 || max_pages < 1) {
    set_error("pstpu_read_fused: invalid arguments");
    return -1;
  }
  const ImgProbeFn probe = reinterpret_cast<ImgProbeFn>(img_probe_fn);
  const ImgDecodeFn decode = reinterpret_cast<ImgDecodeFn>(img_decode_fn);
  std::atomic<int> next{0};
  auto run = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_cols) return;
      decode_fused_column(&cols[i], max_pages, probe, decode);
    }
  };
  int fanout = n_threads;
  if (fanout < 1) fanout = 1;
  if (fanout > n_cols) fanout = n_cols;
  std::vector<std::thread> pool;
  for (int t = 1; t < fanout; t++) pool.emplace_back(run);
  run();
  for (auto& th : pool) th.join();
  long long failed = 0;
  for (int i = 0; i < n_cols; i++) {
    if (cols[i].status != kColOk) failed++;
  }
  return failed;
}

// Predicate-pushdown variant of pstpu_read_fused: decode the predicate
// columns (`pred_cols`, indexed by preds[i].col — they never collate), AND
// every clause into the caller's `sel` bitmap with page-stat skipping, then
// gather only the selected rows of the output columns — one GIL-released
// call for the whole filtered batch. Returns the number of columns/clauses
// whose status != OK (callers fall back to the unfused path for the block),
// or -1 on invalid arguments.
long long pstpu_read_fused_pred(struct FusedCol* cols, int n_cols,
                                struct FusedCol* pred_cols, int n_pred_cols,
                                struct FusedPred* preds, int n_preds,
                                uint8_t* sel, unsigned long long sel_cap,
                                long long total_rows, int n_threads,
                                int max_pages, void* img_probe_fn,
                                void* img_decode_fn, long long* out_selected,
                                long long* out_pages_skipped) {
  if (cols == nullptr || pred_cols == nullptr || preds == nullptr ||
      sel == nullptr || out_selected == nullptr || out_pages_skipped == nullptr ||
      n_cols < 0 || n_pred_cols < 1 || n_preds < 1 || total_rows < 0 ||
      max_pages < 1) {
    set_error("pstpu_read_fused_pred: invalid arguments");
    return -1;
  }
  const uint64_t sel_bytes = (uint64_t(total_rows) + 7) / 8;
  if (sel_cap < sel_bytes) {
    set_error("pstpu_read_fused_pred: selection bitmap too small");
    return -1;
  }
  std::vector<std::vector<FusedPred*>> by_col;
  by_col.resize(size_t(n_pred_cols));
  for (int i = 0; i < n_preds; i++) {
    FusedPred* p = &preds[i];
    const int w = pred_width(p->dtype);
    if (p->col < 0 || p->col >= n_pred_cols || w == 0 ||
        (p->op != kPredIn && p->op != kPredRange) || p->values == nullptr) {
      set_error("pstpu_read_fused_pred: invalid predicate clause");
      return -1;
    }
    if (p->op == kPredIn) {
      // division form: count * w would wrap for a hostile operand count
      if (p->count < 0 || uint64_t(p->count) > p->values_cap / uint64_t(w)) {
        set_error("pstpu_read_fused_pred: operand buffer too small");
        return -1;
      }
    } else if (p->values_cap / uint64_t(w) < 2) {  // packed [lo][hi]
      set_error("pstpu_read_fused_pred: range buffer too small");
      return -1;
    }
    by_col[size_t(p->col)].push_back(p);
  }
  // all rows start selected; the tail bits of the last byte stay clear so the
  // popcount below is exact
  std::memset(sel, 0xFF, size_t(sel_bytes));
  if (total_rows & 7) {
    sel[sel_bytes - 1] = uint8_t((1u << (total_rows & 7)) - 1);
  }
  // phase 1 (serial): narrow the bitmap one predicate column at a time
  long long skipped_total = 0;
  long long pred_failed = 0;
  for (int ci = 0; ci < n_pred_cols; ci++) {
    FusedCol* pc = &pred_cols[ci];
    long long col_skipped = 0;
    int rc;
    if (by_col[size_t(ci)].empty()) {
      rc = kColOk;
    } else if (pc->chunk == nullptr || pc->expected_rows != total_rows) {
      rc = kColInternal;
    } else {
      try {
        rc = eval_pred_column(pc, by_col[size_t(ci)], sel, max_pages,
                              &col_skipped);
      } catch (...) {
        rc = kColInternal;
      }
    }
    pc->status = rc;
    for (FusedPred* p : by_col[size_t(ci)]) {
      p->status = rc;
      p->pages_skipped = int32_t(col_skipped);
    }
    skipped_total += col_skipped;
    if (rc != kColOk) pred_failed++;
  }
  long long n_selected = 0;
  for (uint64_t i = 0; i < sel_bytes; i++) {
    n_selected += __builtin_popcount(sel[i]);
  }
  *out_selected = n_selected;
  if (pred_failed > 0) {
    // callers treat any failure as whole-block fallback: make sure no output
    // column looks spuriously decoded
    for (int i = 0; i < n_cols; i++) cols[i].status = kColInternal;
    *out_pages_skipped = skipped_total;
    return pred_failed + n_cols;
  }
  // phase 2 (parallel): gather the selected rows of every output column
  std::atomic<long long> skipped2{0};
  if (n_selected == 0) {
    // nothing survived: every data page of every output column is skipped
    // work; callers build an empty block without touching the buffers
    for (int i = 0; i < n_cols; i++) {
      cols[i].status = kColOk;
      cols[i].out_used = 0;
      cols[i].aux0 = 0;
      cols[i].aux1 = 0;
    }
  } else {
    const ImgProbeFn probe = reinterpret_cast<ImgProbeFn>(img_probe_fn);
    const ImgDecodeFn decode = reinterpret_cast<ImgDecodeFn>(img_decode_fn);
    std::atomic<int> next{0};
    auto run = [&]() {
      while (true) {
        const int i = next.fetch_add(1);
        if (i >= n_cols) return;
        decode_fused_column_gather(&cols[i], sel, n_selected, max_pages, probe,
                                   decode, &skipped2);
      }
    };
    int fanout = n_threads;
    if (fanout < 1) fanout = 1;
    if (fanout > n_cols) fanout = n_cols;
    std::vector<std::thread> pool;
    for (int t = 1; t < fanout; t++) pool.emplace_back(run);
    run();
    for (auto& th : pool) th.join();
  }
  *out_pages_skipped = skipped_total + skipped2.load();
  long long failed = 0;
  for (int i = 0; i < n_cols; i++) {
    if (cols[i].status != kColOk) failed++;
  }
  return failed;
}

int pstpu_abi_version() { return 4; }

}  // extern "C"
