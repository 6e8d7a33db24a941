// Host telemetry runtime: lock-free SPSC ring buffer + async writer.
//
// Role: host-side replacement for the reference's C++ IPC stack — the
// rosidl-generated message bindings (boundmpcmsg/CMakeLists.txt:22-31) and
// the DDS transport carrying /mpc/mpc_data to the Logger
// (bound_mpc/nodes/bound_mpc_node.py:369-372, Logger/Logger.py:93).  The
// control loop must never block on I/O: producers push fixed-size float
// records into a power-of-two ring; a background thread drains them to a
// binary log ("BMPC1" header + record stream) that the Python observability
// layer memory-maps back.  Single-producer/single-consumer per sink, acquire/
// release semantics only — no locks on the hot path.
//
// Build: g++ -O2 -std=c++17 -fPIC -shared -pthread, at first use, by
// boundmpc_tpu_torch/ops/_build.py (into build/boundmpc_tpu_torch/).
// Python bindings: boundmpc_tpu_torch/native/telemetry.py (ctypes).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x424D5031;  // "BMP1"
constexpr uint32_t kVersion = 1;

struct LogHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t record_floats;   // floats per record
  uint32_t reserved;
  uint64_t record_count;    // patched on close
};

class TelemetrySink {
 public:
  TelemetrySink(const char* path, uint32_t record_floats, uint32_t capacity_log2)
      : record_floats_(record_floats),
        capacity_(1u << capacity_log2),
        mask_(capacity_ - 1),
        ring_(static_cast<size_t>(capacity_) * record_floats),
        head_(0),
        tail_(0),
        dropped_(0),
        written_(0),
        stop_(false) {
    file_ = std::fopen(path, "wb");
    if (file_ != nullptr) {
      LogHeader h{kMagic, kVersion, record_floats, 0, 0};
      std::fwrite(&h, sizeof(h), 1, file_);
    }
    writer_ = std::thread([this] { this->DrainLoop(); });
  }

  ~TelemetrySink() { Close(); }

  // Producer side (control loop): non-blocking; drops the record when the
  // ring is full rather than stalling the tick (the reference's DDS QoS
  // analog: best-effort telemetry, hard-real-time control).
  bool Push(const float* rec) {
    const uint64_t head = head_.load(std::memory_order_relaxed);
    const uint64_t tail = tail_.load(std::memory_order_acquire);
    if (head - tail >= capacity_) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    std::memcpy(&ring_[(head & mask_) * record_floats_], rec,
                record_floats_ * sizeof(float));
    head_.store(head + 1, std::memory_order_release);
    cv_.notify_one();
    return true;
  }

  // Batched push: n records laid out contiguously.
  uint64_t PushBatch(const float* recs, uint64_t n) {
    uint64_t ok = 0;
    for (uint64_t i = 0; i < n; ++i) {
      ok += Push(recs + i * record_floats_) ? 1 : 0;
    }
    return ok;
  }

  void Flush() {
    // Wait until the writer catches up with everything pushed so far.
    const uint64_t target = head_.load(std::memory_order_acquire);
    std::unique_lock<std::mutex> lk(m_);
    flushed_cv_.wait(lk, [this, target] {
      return tail_.load(std::memory_order_acquire) >= target;
    });
    if (file_ != nullptr) std::fflush(file_);
  }

  void Close() {
    {
      std::lock_guard<std::mutex> lk(m_);
      if (stop_) return;
      stop_ = true;
    }
    cv_.notify_one();
    if (writer_.joinable()) writer_.join();
    if (file_ != nullptr) {
      // Patch the record count into the header.
      std::fflush(file_);
      std::fseek(file_, offsetof(LogHeader, record_count), SEEK_SET);
      const uint64_t w = written_;
      std::fwrite(&w, sizeof(w), 1, file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  uint64_t dropped() const { return dropped_.load(std::memory_order_relaxed); }
  uint64_t written() const { return written_; }

 private:
  void DrainLoop() {
    std::vector<float> batch(static_cast<size_t>(capacity_) * record_floats_);
    for (;;) {
      uint64_t tail = tail_.load(std::memory_order_relaxed);
      uint64_t head = head_.load(std::memory_order_acquire);
      if (tail == head) {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait_for(lk, std::chrono::milliseconds(5), [this, tail] {
          return stop_ || head_.load(std::memory_order_acquire) != tail;
        });
        head = head_.load(std::memory_order_acquire);
        if (tail == head && stop_) break;
        if (tail == head) continue;
      }
      uint64_t n = head - tail;
      for (uint64_t i = 0; i < n; ++i) {
        std::memcpy(&batch[i * record_floats_],
                    &ring_[((tail + i) & mask_) * record_floats_],
                    record_floats_ * sizeof(float));
      }
      if (file_ != nullptr) {
        std::fwrite(batch.data(), sizeof(float),
                    static_cast<size_t>(n) * record_floats_, file_);
        written_ += n;
      }
      tail_.store(tail + n, std::memory_order_release);
      flushed_cv_.notify_all();
    }
  }

  const uint32_t record_floats_;
  const uint64_t capacity_;
  const uint64_t mask_;
  std::vector<float> ring_;
  std::atomic<uint64_t> head_;
  std::atomic<uint64_t> tail_;
  std::atomic<uint64_t> dropped_;
  uint64_t written_;
  bool stop_;
  std::FILE* file_ = nullptr;
  std::thread writer_;
  std::mutex m_;
  std::condition_variable cv_;
  std::condition_variable flushed_cv_;
};

}  // namespace

extern "C" {

void* bmpc_sink_create(const char* path, uint32_t record_floats,
                       uint32_t capacity_log2) {
  return new TelemetrySink(path, record_floats, capacity_log2);
}

int bmpc_sink_push(void* sink, const float* rec) {
  return static_cast<TelemetrySink*>(sink)->Push(rec) ? 1 : 0;
}

uint64_t bmpc_sink_push_batch(void* sink, const float* recs, uint64_t n) {
  return static_cast<TelemetrySink*>(sink)->PushBatch(recs, n);
}

void bmpc_sink_flush(void* sink) {
  static_cast<TelemetrySink*>(sink)->Flush();
}

uint64_t bmpc_sink_dropped(void* sink) {
  return static_cast<TelemetrySink*>(sink)->dropped();
}

uint64_t bmpc_sink_written(void* sink) {
  return static_cast<TelemetrySink*>(sink)->written();
}

void bmpc_sink_destroy(void* sink) {
  delete static_cast<TelemetrySink*>(sink);
}

}  // extern "C"
