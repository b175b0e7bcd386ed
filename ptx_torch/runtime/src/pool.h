// Native tile-work scheduler.
//
// The reference hand-rolls a pthread pool with an intrusive task list and
// one-shot worker revival (the reference's test.cpp:147-308, plus the
// thread/mutex/condition_variable shims in include/).  This is its modern
// equivalent: a fixed-width std::thread worker pool draining a FIFO of
// type-erased tasks, with join-all semantics; used by the render farm
// server for per-tile jobs and exposed over the C ABI for host-side
// orchestration.

#pragma once

#include <condition_variable>
#include <cstddef>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace ptxrt {

class Pool {
 public:
  explicit Pool(int nthreads);
  ~Pool();

  Pool(const Pool&) = delete;
  Pool& operator=(const Pool&) = delete;

  void submit(std::function<void()> task);
  // Block until every submitted task has finished.
  void wait_idle();
  int width() const { return static_cast<int>(workers_.size()); }

 private:
  void worker();

  std::mutex mu_;
  std::condition_variable cv_task_;
  std::condition_variable cv_idle_;
  std::deque<std::function<void()>> queue_;
  std::vector<std::thread> workers_;
  size_t in_flight_ = 0;
  bool stopping_ = false;
};

}  // namespace ptxrt
