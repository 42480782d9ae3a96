// Native streaming-runtime core: bounded handle queues with ROS-style
// back-pressure.
//
// The reference's four nodes communicate through roscpp TCPROS
// subscription queues of depth 2-5 which silently drop the oldest
// message when a stage falls behind (src/laserOdometry.cpp:357-398,
// SURVEY.md §2 "rate decoupling ... back-pressure is implicit").  That
// lossy-queue semantic is the real-time scheduling policy of the whole
// system, so the standalone online engine reproduces it natively: a
// mutex+condvar bounded queue of opaque uint64 handles (the Python side
// maps handles to device arrays), drop-oldest on overflow, counted.
//
// C ABI: loam_q_create / _push / _pop / _close / _stats / _destroy.

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>

namespace {

struct Queue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<uint64_t> items;
  size_t capacity;
  bool closed = false;
  uint64_t pushed = 0, popped = 0, dropped = 0;
};

}  // namespace

extern "C" {

void* loam_q_create(long capacity) {
  auto* q = new Queue();
  q->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 1;
  return q;
}

void loam_q_destroy(void* h) { delete static_cast<Queue*>(h); }

// Push a handle.  If full, drops the OLDEST entry (ROS subscriber-queue
// semantics) and stores it in *dropped_out (else *dropped_out = ~0).
// Returns 0 on success, -1 if the queue is closed.
int loam_q_push(void* h, uint64_t item, uint64_t* dropped_out) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  *dropped_out = ~0ULL;
  if (q->closed) return -1;
  if (q->items.size() >= q->capacity) {
    *dropped_out = q->items.front();
    q->items.pop_front();
    q->dropped++;
  }
  q->items.push_back(item);
  q->pushed++;
  lk.unlock();
  q->cv.notify_one();
  return 0;
}

// Pop into *out, blocking up to timeout_ms (-1 = forever).
// Returns 0 on success, 1 on timeout, -1 if closed and drained.
int loam_q_pop(void* h, uint64_t* out, long timeout_ms) {
  Queue* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return !q->items.empty() || q->closed; };
  if (timeout_ms < 0) {
    q->cv.wait(lk, ready);
  } else if (!q->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             ready)) {
    return 1;
  }
  if (q->items.empty()) return -1;  // closed + drained
  *out = q->items.front();
  q->items.pop_front();
  q->popped++;
  return 0;
}

void loam_q_close(void* h) {
  Queue* q = static_cast<Queue*>(h);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv.notify_all();
}

void loam_q_stats(void* h, uint64_t* pushed, uint64_t* popped,
                  uint64_t* dropped, uint64_t* depth) {
  Queue* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  *pushed = q->pushed;
  *popped = q->popped;
  *dropped = q->dropped;
  *depth = q->items.size();
}

}  // extern "C"
