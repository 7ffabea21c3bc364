// tpumon native host sampler.
//
// C++ fast path for the host metrics collector (tpumon_torch/collectors/host.py).
// The reference shells out to `df` and reads /proc via the Node runtime per
// HTTP request (monitor_server.js:66-81); the Python rewrite already avoids
// subprocesses, and this shim removes the remaining per-sample Python
// parsing cost so the 1 Hz sampler loop (and the exporter samples/sec
// benchmark) spends microseconds, not milliseconds, per host sample.
//
// Pure C ABI (called via ctypes — no pybind11 dependency, per the build
// environment's constraints). Every sub-source degrades independently via
// the `ok` bitmask, mirroring the Python collector's contract.
//
// Build: python -m tpumon_torch.native build (into build/tpumon_torch/native/)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/statvfs.h>
#include <unistd.h>

extern "C" {

struct HostSample {
  double load1;
  uint64_t mem_total;
  uint64_t mem_available;
  uint64_t cpu_busy_jiffies;
  uint64_t cpu_total_jiffies;
  uint64_t disk_total;
  uint64_t disk_used;
  int32_t cores;
  int32_t ok;  // bitmask: 1=cpu/load, 2=meminfo, 4=disk
};

enum { OK_CPU = 1, OK_MEM = 2, OK_DISK = 4 };

// Parse the aggregate "cpu " line of /proc/stat into busy/total jiffies.
// Fields: user nice system idle iowait irq softirq steal [guest...] —
// busy = total(first 8) - idle - iowait, matching the Python reader.
static bool read_proc_stat(const char* proc_root, uint64_t* busy,
                           uint64_t* total) {
  char path[512];
  snprintf(path, sizeof(path), "%s/stat", proc_root);
  FILE* f = fopen(path, "re");
  if (!f) return false;
  char line[1024];
  bool found = false;
  while (fgets(line, sizeof(line), f)) {
    if (strncmp(line, "cpu ", 4) == 0) {
      uint64_t v[8] = {0};
      int n = sscanf(line + 4,
                     "%lu %lu %lu %lu %lu %lu %lu %lu",
                     &v[0], &v[1], &v[2], &v[3], &v[4], &v[5], &v[6], &v[7]);
      if (n >= 4) {
        uint64_t t = 0;
        for (int i = 0; i < 8; i++) t += v[i];
        *total = t;
        *busy = t - v[3] - v[4];  // minus idle, iowait
        found = true;
      }
      break;
    }
  }
  fclose(f);
  return found;
}

static bool read_loadavg(const char* proc_root, double* load1) {
  char path[512];
  snprintf(path, sizeof(path), "%s/loadavg", proc_root);
  FILE* f = fopen(path, "re");
  if (!f) return false;
  bool got = fscanf(f, "%lf", load1) == 1;
  fclose(f);
  return got;
}

static bool read_meminfo(const char* proc_root, uint64_t* total,
                         uint64_t* available) {
  char path[512];
  snprintf(path, sizeof(path), "%s/meminfo", proc_root);
  FILE* f = fopen(path, "re");
  if (!f) return false;
  char line[256];
  uint64_t t = 0, a = 0, free_kb = 0;
  bool got_t = false, got_a = false, got_free = false;
  while (fgets(line, sizeof(line), f) && !(got_t && got_a)) {
    uint64_t kb;
    if (sscanf(line, "MemTotal: %lu kB", &kb) == 1) {
      t = kb * 1024;
      got_t = true;
    } else if (sscanf(line, "MemAvailable: %lu kB", &kb) == 1) {
      a = kb * 1024;
      got_a = true;
    } else if (sscanf(line, "MemFree: %lu kB", &kb) == 1) {
      free_kb = kb * 1024;
      got_free = true;
    }
  }
  fclose(f);
  if (!got_t) return false;
  *total = t;
  *available = got_a ? a : (got_free ? free_kb : 0);
  return true;
}

int tpumon_host_sample(const char* proc_root, const char* mount,
                       HostSample* out) {
  memset(out, 0, sizeof(*out));
  out->cores = (int32_t)sysconf(_SC_NPROCESSORS_ONLN);
  if (out->cores <= 0) out->cores = 1;

  if (read_loadavg(proc_root, &out->load1) &&
      read_proc_stat(proc_root, &out->cpu_busy_jiffies,
                     &out->cpu_total_jiffies)) {
    out->ok |= OK_CPU;
  }
  if (read_meminfo(proc_root, &out->mem_total, &out->mem_available)) {
    out->ok |= OK_MEM;
  }
  struct statvfs sv;
  if (statvfs(mount, &sv) == 0 && sv.f_blocks > 0) {
    out->disk_total = (uint64_t)sv.f_blocks * sv.f_frsize;
    out->disk_used = out->disk_total - (uint64_t)sv.f_bfree * sv.f_frsize;
    out->ok |= OK_DISK;
  }
  return out->ok;
}

// Version tag so Python can detect ABI drift.
int tpumon_native_abi_version(void) { return 1; }

}  // extern "C"
