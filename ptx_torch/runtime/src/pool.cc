#include "pool.h"

namespace ptxrt {

Pool::Pool(int nthreads) {
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 4;  // reference fallback (test.cpp:206-208)
  }
  workers_.reserve(nthreads);
  for (int i = 0; i < nthreads; ++i) {
    workers_.emplace_back([this] { worker(); });
  }
}

Pool::~Pool() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    stopping_ = true;
  }
  cv_task_.notify_all();
  for (auto& t : workers_) t.join();
}

void Pool::submit(std::function<void()> task) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.push_back(std::move(task));
  }
  cv_task_.notify_one();
}

void Pool::wait_idle() {
  std::unique_lock<std::mutex> lk(mu_);
  cv_idle_.wait(lk, [this] { return queue_.empty() && in_flight_ == 0; });
}

void Pool::worker() {
  for (;;) {
    std::function<void()> task;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_task_.wait(lk, [this] { return stopping_ || !queue_.empty(); });
      if (stopping_ && queue_.empty()) return;
      task = std::move(queue_.front());
      queue_.pop_front();
      ++in_flight_;
    }
    task();  // exceptions must not escape workers; tasks wrap their own
    {
      std::lock_guard<std::mutex> lk(mu_);
      --in_flight_;
    }
    cv_idle_.notify_all();
  }
}

}  // namespace ptxrt
