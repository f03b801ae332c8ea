#include "timeline.h"

#include <cstdio>

namespace hvdtpu {

namespace {
std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}
}  // namespace

void Timeline::Initialize(const std::string& path, int rank,
                          std::chrono::steady_clock::time_point epoch) {
  if (path.empty()) return;
  std::lock_guard<std::mutex> lk(mu_);
  file_.open(path, std::ios::out | std::ios::trunc);
  if (!file_.is_open()) {
    fprintf(stderr, "[horovod_tpu] WARNING: cannot open timeline file %s\n",
            path.c_str());
    return;
  }
  // Re-init after a shutdown starts a fresh file: forget the previous
  // run's pid rows so every tensor re-emits its process_name metadata.
  tensor_pids_.clear();
  open_labels_.clear();
  last_ts_by_pid_.clear();
  start_ = epoch;
  last_flush_ = std::chrono::steady_clock::now();
  file_ << "[\n";
  // File identity for tools/timeline_merge.py: which rank wrote this
  // trace.  pid 0 is reserved for metadata (tensor pids start at 1).
  file_ << "{\"name\":\"hvd_rank\",\"ph\":\"M\",\"ts\":0,\"pid\":0,"
        << "\"args\":{\"rank\":" << rank << "}},\n";
  file_.flush();
  enabled_ = true;
}

int64_t Timeline::NowUs() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - start_)
      .count();
}

int64_t Timeline::TensorPid(const std::string& name) {
  auto it = tensor_pids_.find(name);
  if (it != tensor_pids_.end()) return it->second;
  int64_t pid = static_cast<int64_t>(tensor_pids_.size()) + 1;
  tensor_pids_[name] = pid;
  // Metadata event labels the pid row with the tensor name.
  int64_t now = NowUs();
  last_ts_by_pid_[pid] = now;
  file_ << "{\"name\":\"process_name\",\"ph\":\"M\",\"ts\":" << now
        << ",\"pid\":" << pid << ",\"args\":{\"name\":\"" << JsonEscape(name)
        << "\"}},\n";
  return pid;
}

void Timeline::WriteEvent(const std::string& name, char phase,
                          const std::string& args,
                          const std::string& category, int64_t ts_us) {
  int64_t pid = TensorPid(name);
  // 'E' events repeat their opener's label (popped from the per-row
  // stack) so every event carries a name.
  std::string label = category;
  if (phase == 'B') {
    open_labels_[name].push_back(category);
  } else if (phase == 'E') {
    auto& stack = open_labels_[name];
    if (!stack.empty()) {
      label = stack.back();
      stack.pop_back();
    }
  }
  int64_t ts = ts_us >= 0 ? ts_us : NowUs();
  int64_t& row_ts = last_ts_by_pid_[pid];
  if (ts < row_ts) ts = row_ts;  // per-row monotonicity clamp
  row_ts = ts;
  file_ << "{\"ph\":\"" << phase << "\",\"ts\":" << ts
        << ",\"pid\":" << pid << ",\"tid\":0"
        << ",\"name\":\"" << JsonEscape(label) << "\"";
  if (!args.empty()) file_ << ",\"args\":{" << args << "}";
  file_ << "},\n";
  auto now = std::chrono::steady_clock::now();
  if (now - last_flush_ > std::chrono::seconds(1)) {
    file_.flush();
    last_flush_ = now;
  }
}

void Timeline::NegotiateStart(const std::string& name, uint8_t op) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'B', "", "NEGOTIATE");
}

void Timeline::NegotiateRankReady(const std::string& name, int rank,
                                  int64_t ts_us) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'i',
             "\"rank\":" + std::to_string(rank), "RANK_READY", ts_us);
}

void Timeline::NegotiateEnd(const std::string& name) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'E', "", "");
}

void Timeline::Start(const std::string& name, const std::string& op_name) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'B', "", op_name);
}

void Timeline::ActivityStart(const std::string& name,
                             const std::string& activity) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'B', "", activity);
}

void Timeline::ActivityEnd(const std::string& name) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'E', "", "");
}

void Timeline::End(const std::string& name, int64_t bytes) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'E', "\"bytes\":" + std::to_string(bytes), "");
}

void Timeline::Instant(const std::string& name, const std::string& label) {
  if (!enabled_) return;
  std::lock_guard<std::mutex> lk(mu_);
  WriteEvent(name, 'i', "", label);
}

void Timeline::WriteClockSync(int64_t offset_us, int64_t rtt_us) {
  std::lock_guard<std::mutex> lk(mu_);
  if (!enabled_) return;
  file_ << "{\"name\":\"hvd_clock_sync\",\"ph\":\"M\",\"ts\":" << NowUs()
        << ",\"pid\":0,\"args\":{\"offset_us\":" << offset_us
        << ",\"rtt_us\":" << rtt_us << "}},\n";
  file_.flush();
}

void Timeline::Flush() {
  std::lock_guard<std::mutex> lk(mu_);
  if (!enabled_) return;
  file_.flush();
}

void Timeline::Shutdown() {
  std::lock_guard<std::mutex> lk(mu_);
  if (!enabled_) return;
  // Chrome's trace parser tolerates the trailing comma / missing "]".
  file_.flush();
  file_.close();
  enabled_ = false;
}

}  // namespace hvdtpu
