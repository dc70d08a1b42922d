// File prefetcher for the training data: a ring filled by POSIX threads that
// read whole clip files (.npz) ahead of the trainer, off the GIL, while the
// train step runs on the card. Python (ctypes, data/native_prefetch.py)
// parses each buffer from memory and hands it back.
//
// The port's own copy of the JAX package's native/prefetch.cpp, the same
// code; it is built by the port's binding into hallo_tpu_torch/_build/.
//
// API (C, ctypes-friendly):
//   handle = pf_open(paths, n_paths, capacity, n_workers, loop)
//   idx    = pf_next(handle, &data, &size)   // blocks until an item is ready
//   pf_release(data)                          // free the buffer
//   pf_close(handle)
//
// With loop=1 the reader cycles the path list forever; the consumer sees
// items in submission order (deterministic given a fixed list: shuffling is
// the Python side's job, which opens one prefetcher per epoch).

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Item {
  long index = -1;
  char* data = nullptr;
  size_t size = 0;
  bool ok = false;
};

struct Prefetcher {
  std::vector<std::string> paths;
  size_t capacity;
  bool loop;

  std::mutex mu;
  std::condition_variable cv_space;  // producers wait for room
  std::condition_variable cv_item;   // consumer waits for the next index
  std::deque<Item> ready;            // completed items (any order)
  std::atomic<long> next_submit{0};  // next path index to read
  long next_consume = 0;             // next index the consumer expects
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Prefetcher() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_space.notify_all();
    cv_item.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    for (auto& item : ready) std::free(item.data);
    ready.clear();
  }

  static Item read_file(const std::string& path, long index) {
    Item item;
    item.index = index;
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return item;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size < 0) {
      std::fclose(f);
      return item;
    }
    item.data = static_cast<char*>(std::malloc(size > 0 ? size : 1));
    item.size = static_cast<size_t>(size);
    item.ok = item.data &&
              std::fread(item.data, 1, item.size, f) == item.size;
    std::fclose(f);
    if (!item.ok) {
      std::free(item.data);
      item.data = nullptr;
      item.size = 0;
    }
    return item;
  }

  void worker() {
    while (!stop.load()) {
      long idx = next_submit.fetch_add(1);
      long n = static_cast<long>(paths.size());
      if (!loop && idx >= n) return;
      const std::string& path = paths[idx % n];

      Item item = read_file(path, idx);

      std::unique_lock<std::mutex> lock(mu);
      // Admission by index window, not just occupancy: the consumer drains
      // strictly in order, so a full ring of indices > next_consume would
      // deadlock against the producer holding exactly next_consume
      // (capacity < workers makes this reachable). Indices are distinct, so
      // "index within [next_consume, next_consume + capacity)" also implies
      // there is room the moment the window admits us.
      cv_space.wait(lock, [&] {
        return stop.load() ||
               (item.index < next_consume + static_cast<long>(capacity) &&
                ready.size() < capacity);
      });
      if (stop.load()) {
        std::free(item.data);
        return;
      }
      ready.push_back(item);
      cv_item.notify_all();
    }
  }

  // Blocks until the item with index == next_consume is available (keeps
  // consumption deterministic even with racing workers).
  Item next() {
    std::unique_lock<std::mutex> lock(mu);
    for (;;) {
      for (auto it = ready.begin(); it != ready.end(); ++it) {
        if (it->index == next_consume) {
          Item out = *it;
          ready.erase(it);
          ++next_consume;
          cv_space.notify_all();
          return out;
        }
      }
      long n = static_cast<long>(paths.size());
      if (!loop && next_consume >= n) return Item{};
      if (stop.load()) return Item{};
      cv_item.wait(lock);
    }
  }
};

}  // namespace

extern "C" {

void* pf_open(const char** paths, long n_paths, long capacity, long n_workers,
              int loop) {
  if (n_paths <= 0 || capacity <= 0 || n_workers <= 0) return nullptr;
  auto* pf = new Prefetcher();
  pf->paths.reserve(n_paths);
  for (long i = 0; i < n_paths; ++i) pf->paths.emplace_back(paths[i]);
  pf->capacity = static_cast<size_t>(capacity);
  pf->loop = loop != 0;
  for (long i = 0; i < n_workers; ++i)
    pf->workers.emplace_back(&Prefetcher::worker, pf);
  return pf;
}

// Returns the item index (>=0), -1 on end-of-stream, -2 on read error.
long pf_next(void* handle, char** out_data, size_t* out_size) {
  auto* pf = static_cast<Prefetcher*>(handle);
  Item item = pf->next();
  if (item.index < 0) return -1;
  if (!item.ok) return -2;
  *out_data = item.data;
  *out_size = item.size;
  return item.index;
}

void pf_release(char* data) { std::free(data); }

void pf_close(void* handle) { delete static_cast<Prefetcher*>(handle); }

}  // extern "C"
