#include "transport.h"

#include <errno.h>
#include <fcntl.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <thread>

#include "net.h"

namespace hvdtpu {

namespace {

double NowSec() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

long long NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Segment geometry.  The header block and every ring block are page-
// aligned so cursor cache lines never share a page-straddling ring
// payload tail with a neighbouring ring's header.
constexpr uint64_t kShmMagic = 0x68766474707573ULL;  // "hvdtpus"
constexpr uint32_t kShmVersion = 1;
constexpr size_t kShmHeaderBytes = 4096;
constexpr size_t kShmPage = 4096;

struct SegHeader {
  uint64_t magic;
  uint32_t version;
  uint32_t local_size;
  uint64_t ring_bytes;
};

size_t RoundUpPow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

size_t RingBlockBytes(size_t ring_bytes) {
  size_t raw = sizeof(ShmRing) + ring_bytes;
  return (raw + kShmPage - 1) / kShmPage * kShmPage;
}

size_t SegTotalBytes(int local_size, size_t ring_bytes) {
  return kShmHeaderBytes +
         static_cast<size_t>(local_size) * 2 * RingBlockBytes(ring_bytes);
}

// Spin-then-yield pacing for the ring drive loops: a burst of on-core
// pauses (the common case — the peer engine thread polls every few µs),
// then yields, then a 50µs sleep so an idle wait costs no meaningful
// CPU.  No futex anywhere: abort wake is the `closed` flag, observed
// within one pass.
void PollPause(int idle) {
  if (idle < 256) {
#if defined(__x86_64__)
    __builtin_ia32_pause();
#else
    std::this_thread::yield();
#endif
  } else if (idle < 4096) {
    std::this_thread::yield();
  } else {
    std::this_thread::sleep_for(std::chrono::microseconds(50));
  }
}

bool RingClosed(const ShmRing* r) {
  return r->closed.load(std::memory_order_acquire) != 0;
}

}  // namespace

ShmMode ParseShmMode(const char* value) {
  if (value == nullptr) return ShmMode::kAuto;
  std::string v(value);
  if (v.empty() || v == "auto") return ShmMode::kAuto;
  if (v == "0" || v == "off") return ShmMode::kOff;
  if (v == "1" || v == "force") return ShmMode::kForce;
  return ShmMode::kAuto;
}

const char* ShmModeName(ShmMode m) {
  switch (m) {
    case ShmMode::kOff: return "off";
    case ShmMode::kForce: return "force";
    default: return "auto";
  }
}

size_t ShmRing::WriteSome(const void* buf, size_t len) {
  const uint64_t h = head.load(std::memory_order_relaxed);
  const uint64_t t = tail.load(std::memory_order_acquire);
  const size_t space = capacity - static_cast<size_t>(h - t);
  size_t n = std::min(len, space);
  if (n == 0) return 0;
  const size_t off = static_cast<size_t>(h) & (capacity - 1);
  const size_t first = std::min(n, static_cast<size_t>(capacity) - off);
  memcpy(Data() + off, buf, first);
  if (n > first)
    memcpy(Data(), static_cast<const char*>(buf) + first, n - first);
  head.store(h + n, std::memory_order_release);
  return n;
}

size_t ShmRing::ReadSome(void* buf, size_t len) {
  const uint64_t t = tail.load(std::memory_order_relaxed);
  const uint64_t h = head.load(std::memory_order_acquire);
  const size_t avail = static_cast<size_t>(h - t);
  size_t n = std::min(len, avail);
  if (n == 0) return 0;
  const size_t off = static_cast<size_t>(t) & (capacity - 1);
  const size_t first = std::min(n, static_cast<size_t>(capacity) - off);
  memcpy(buf, Data() + off, first);
  if (n > first) memcpy(static_cast<char*>(buf) + first, Data(), n - first);
  tail.store(t + n, std::memory_order_release);
  return n;
}

std::string ShmSegmentName(const std::string& job_tag, int node_id,
                           long long epoch) {
  uint32_t h = 2166136261u;
  for (char c : job_tag) h = (h ^ static_cast<uint8_t>(c)) * 16777619u;
  char buf[64];
  snprintf(buf, sizeof(buf), "/hvdtpu_%08x_n%d_e%lld", h, node_id, epoch);
  return std::string(buf);
}

bool ShmSegment::Create(const std::string& name, int local_size,
                        size_t ring_bytes, std::string* err) {
  ring_bytes = RoundUpPow2(
      std::max<size_t>(64 * 1024, std::min<size_t>(ring_bytes, 256u << 20)));
  // Stale sweep: a previous generation that died between its create and
  // its attach round-trip may have left the name behind (the only
  // window in which a name exists at all).
  shm_unlink(name.c_str());
  int fd = shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    *err = "shm_open(" + name + "): " + strerror(errno);
    return false;
  }
  const size_t total = SegTotalBytes(local_size, ring_bytes);
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    *err = "ftruncate(" + name + ", " + std::to_string(total) +
           "): " + strerror(errno);
    close(fd);
    shm_unlink(name.c_str());
    return false;
  }
  void* base =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    *err = "mmap(" + name + "): " + strerror(errno);
    shm_unlink(name.c_str());
    return false;
  }
  base_ = base;
  bytes_ = total;
  name_ = name;
  creator_ = true;
  unlinked_ = false;
  local_size_ = local_size;
  ring_bytes_ = ring_bytes;
  // ftruncate pages arrive zeroed, which is a valid initial state for
  // the cursor atomics; only capacity and the header need stores.
  for (int r = 0; r < local_size; ++r)
    for (int dir = 0; dir < 2; ++dir) Ring(r, dir)->capacity =
        static_cast<uint32_t>(ring_bytes);
  SegHeader* hdr = static_cast<SegHeader*>(base_);
  hdr->version = kShmVersion;
  hdr->local_size = static_cast<uint32_t>(local_size);
  hdr->ring_bytes = ring_bytes;
  hdr->magic = kShmMagic;
  return true;
}

bool ShmSegment::Attach(const std::string& name, int local_size,
                        size_t ring_bytes, std::string* err) {
  ring_bytes = RoundUpPow2(
      std::max<size_t>(64 * 1024, std::min<size_t>(ring_bytes, 256u << 20)));
  int fd = shm_open(name.c_str(), O_RDWR, 0600);
  if (fd < 0) {
    *err = "shm_open(" + name + "): " + strerror(errno);
    return false;
  }
  const size_t total = SegTotalBytes(local_size, ring_bytes);
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) != total) {
    *err = "segment " + name + " has size " + std::to_string(st.st_size) +
           ", want " + std::to_string(total) +
           " (stale generation or shape mismatch)";
    close(fd);
    return false;
  }
  void* base =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    *err = "mmap(" + name + "): " + strerror(errno);
    return false;
  }
  const SegHeader* hdr = static_cast<const SegHeader*>(base);
  if (hdr->magic != kShmMagic || hdr->version != kShmVersion ||
      hdr->local_size != static_cast<uint32_t>(local_size) ||
      hdr->ring_bytes != ring_bytes) {
    *err = "segment " + name + " header mismatch (magic/version/shape)";
    munmap(base, total);
    return false;
  }
  base_ = base;
  bytes_ = total;
  name_ = name;
  creator_ = false;
  unlinked_ = false;
  local_size_ = local_size;
  ring_bytes_ = ring_bytes;
  return true;
}

void ShmSegment::Unlink() {
  if (name_.empty() || unlinked_) return;
  shm_unlink(name_.c_str());  // ENOENT after the init-time unlink: fine
  unlinked_ = true;
}

void ShmSegment::CloseRings() {
  if (!mapped()) return;
  for (int r = 0; r < local_size_; ++r)
    for (int dir = 0; dir < 2; ++dir)
      Ring(r, dir)->closed.store(1, std::memory_order_release);
}

void ShmSegment::Unmap() {
  if (base_ != nullptr) munmap(base_, bytes_);
  base_ = nullptr;
  bytes_ = 0;
  local_size_ = 0;
}

ShmRing* ShmSegment::Ring(int src_local_rank, int dir) {
  char* p = static_cast<char*>(base_) + kShmHeaderBytes +
            (static_cast<size_t>(src_local_rank) * 2 + dir) *
                RingBlockBytes(ring_bytes_);
  return reinterpret_cast<ShmRing*>(p);
}

// ---------------------------------------------------------------------------
// Channel drive loops.  One generic 4-leg progress engine covers
// SendAll/RecvAll/Exchange/ExchangeBi over any mix of ring and fd legs;
// the pure-TCP fast paths delegate to net.cc so the socket
// implementation (poll multiplexing, fault hooks, telemetry) stays the
// single source of truth for that transport.
// ---------------------------------------------------------------------------

namespace {

struct DriveLeg {
  const Channel* ch = nullptr;
  bool is_send = false;
  const char* sp = nullptr;
  char* rp = nullptr;
  size_t len = 0, done = 0;
  long long handoff_us = -1;  // send legs: time to fully enter the ring
};

bool DriveLegs(DriveLeg* legs, int n) {
  const bool track = NetLinkEnabled();
  const long long t0 = NowUs();
  // Chaos delay/jitter clauses apply once per handoff, before any bytes
  // move — the shm seam analogue of SendAll's pre-send NetFaultDelay.
  if (NetFaultActive())
    for (int i = 0; i < n; ++i)
      if (legs[i].is_send && legs[i].len > 0 && legs[i].ch->shm())
        NetFaultDelayPeer(legs[i].ch->peer);
  int idle = 0;
  double deadline = 0.0;  // armed lazily on the first stall
  auto pending = [&](const DriveLeg& l) { return l.done < l.len; };
  for (;;) {
    bool all_done = true, progress = false;
    for (int i = 0; i < n; ++i) {
      DriveLeg& l = legs[i];
      if (!pending(l)) continue;
      all_done = false;
      size_t moved = 0;
      if (l.is_send) {
        if (l.ch->shm()) {
          if (RingClosed(l.ch->tx)) return false;
          moved = l.ch->tx->WriteSome(l.sp + l.done, l.len - l.done);
        } else {
          ssize_t w = send(l.ch->fd, l.sp + l.done, l.len - l.done,
                           MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w < 0 && errno != EINTR && errno != EAGAIN &&
              errno != EWOULDBLOCK)
            return false;
          if (w > 0) moved = static_cast<size_t>(w);
        }
      } else {
        if (l.ch->shm()) {
          moved = l.ch->rx->ReadSome(l.rp + l.done, l.len - l.done);
          if (moved == 0 && RingClosed(l.ch->rx)) return false;
        } else {
          ssize_t g = recv(l.ch->fd, l.rp + l.done, l.len - l.done,
                           MSG_DONTWAIT);
          if (g == 0) return false;
          if (g < 0 && errno != EINTR && errno != EAGAIN &&
              errno != EWOULDBLOCK)
            return false;
          if (g > 0) moved = static_cast<size_t>(g);
        }
      }
      if (moved > 0) {
        l.done += moved;
        progress = true;
        if (l.is_send && l.done == l.len && l.ch->shm())
          l.handoff_us = NowUs() - t0;
      }
    }
    if (all_done) break;
    if (progress) {
      idle = 0;
      deadline = 0.0;
      continue;
    }
    ++idle;
    if (deadline == 0.0) {
      deadline = NowSec() + 30.0;  // same silence budget as the TCP path
    } else if ((idle & 1023) == 0 && NowSec() >= deadline) {
      return false;
    }
    PollPause(idle);
  }
  if (track) {
    for (int i = 0; i < n; ++i) {
      const DriveLeg& l = legs[i];
      if (!l.ch->shm() || l.len == 0) continue;
      if (l.is_send)
        NetLinkRecordShm(l.ch->peer, static_cast<long long>(l.len), 0,
                         l.handoff_us);
      else
        NetLinkRecordShm(l.ch->peer, 0, static_cast<long long>(l.len), -1);
    }
  }
  return true;
}

}  // namespace

bool ChannelSendAll(const Channel& ch, const void* buf, size_t len) {
  if (!ch.shm()) return SendAll(ch.fd, buf, len);
  DriveLeg leg;
  leg.ch = &ch;
  leg.is_send = true;
  leg.sp = static_cast<const char*>(buf);
  leg.len = len;
  return DriveLegs(&leg, 1);
}

bool ChannelRecvAll(const Channel& ch, void* buf, size_t len) {
  if (!ch.shm()) return RecvAll(ch.fd, buf, len);
  DriveLeg leg;
  leg.ch = &ch;
  leg.rp = static_cast<char*>(buf);
  leg.len = len;
  return DriveLegs(&leg, 1);
}

bool ChannelExchange(const Channel& send_ch, const void* sbuf, size_t slen,
                     const Channel& recv_ch, void* rbuf, size_t rlen) {
  if (!send_ch.shm() && !recv_ch.shm())
    return Exchange(send_ch.fd, sbuf, slen, recv_ch.fd, rbuf, rlen);
  DriveLeg legs[2];
  legs[0].ch = &send_ch;
  legs[0].is_send = true;
  legs[0].sp = static_cast<const char*>(sbuf);
  legs[0].len = slen;
  legs[1].ch = &recv_ch;
  legs[1].rp = static_cast<char*>(rbuf);
  legs[1].len = rlen;
  return DriveLegs(legs, 2);
}

bool ChannelExchangeBi(const Channel& right, const void* send_r,
                       size_t send_r_len, void* recv_r, size_t recv_r_len,
                       const Channel& left, const void* send_l,
                       size_t send_l_len, void* recv_l, size_t recv_l_len) {
  if (!right.shm() && !left.shm())
    return ExchangeBi(right.fd, send_r, send_r_len, recv_r, recv_r_len,
                      left.fd, send_l, send_l_len, recv_l, recv_l_len);
  DriveLeg legs[4];
  legs[0].ch = &right;
  legs[0].is_send = true;
  legs[0].sp = static_cast<const char*>(send_r);
  legs[0].len = send_r_len;
  legs[1].ch = &right;
  legs[1].rp = static_cast<char*>(recv_r);
  legs[1].len = recv_r_len;
  legs[2].ch = &left;
  legs[2].is_send = true;
  legs[2].sp = static_cast<const char*>(send_l);
  legs[2].len = send_l_len;
  legs[3].ch = &left;
  legs[3].rp = static_cast<char*>(recv_l);
  legs[3].len = recv_l_len;
  return DriveLegs(legs, 4);
}

}  // namespace hvdtpu
