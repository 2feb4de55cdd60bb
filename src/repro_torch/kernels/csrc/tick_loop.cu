// Fused whole-transfer tick loop for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/core/engine.py::_build_pallas_core
// (the pl.pallas_call at engine.py:612).  One launch runs a batch of
// transfers ("lanes") from their packed initial rows to completion or to
// the horizon: per tick the environment's WAN model and host power model,
// the controller's channel split, the interval accumulators and, every
// ctrl_every ticks, the SLA tuner FSM (Algorithms 2, 4-6) and Algorithm 3
// load control.  It writes the final state rows and seven per-tick traces.
//
// Design.  One thread per lane, the whole lane state in registers; each
// lane leaves its loop on its own as soon as it has drained.  The physics
// and tuners are written out here (the TPU kernel evaluated a staged jaxpr
// of the generic tick, with the environment's constant tables hoisted into
// kernel inputs) in run_lane<P, KIND, SCALING, ENV>, specialised on the
// partition count P (1..8), the controller KIND, whether load control is on
// and whether the environment codes are read.
//
// One launch runs many lane batches ("groups": a sweep's, or a single
// run's one).  Groups differ in controller, environment, CPU (frequency
// ladder included), horizon and tick stride; the kernel's argument is a
// table of group descriptors passed by value (__grid_constant__, read in
// place from the parameter bank: at most kMaxGroups descriptors in CUDA's
// 32,764 bytes of kernel parameters).  A 1-D grid of one-warp blocks: each
// block belongs to one group, finds its descriptor from its block index
// and switches to the group's run_lane body.  KIND, load control and the
// environment flag are uniform across the block, so its warp never
// diverges on them.  P is a template parameter of the kernel, one per
// launch: the wrapper launches once per partition count among the groups
// (a sweep's groups already share one when they differ in it alone,
// repro_torch.api.scenario._merged_partition_counts), so no group runs
// another's partition loops.
//
// Environments.  With ENV false (the reference network and energy models)
// run_lane spells out the reference physics without a branch on the codes.
// With ENV true it adds the other families of repro_torch.api
// .environments, chosen by codes in the group's descriptor: the network
// model (reference, lossy-wan: Mathis window cap, sharper knee, sinusoidal
// RTT jitter; logfit: a fitted bandwidth schedule read through a device
// pointer, and a fitted RTT) and the energy model (reference, big-little:
// core mix; dvfs: core mix, V(f) interpolation over a table of at most 16
// points carried by value, CV^2f power, leakage, race or pace idle, a
// governor cap on the frequency).  Every lane of a group shares the codes,
// so their branches never diverge.  The controller keeps the profile's
// network numbers (the JAX engine hands the tuner inp.net, not the
// environment's), so slow start's goal is the nominal bandwidth under
// every environment.
//
// Layout.  Traces are time-major [n_steps, B] (the wrapper hands back
// transposed [B, n_steps] views), so at tick i the lanes of a warp store to
// consecutive addresses; the bandwidth schedule arrives time-major too.  The
// wrapper pre-fills the traces with the never-executed-tick values (zero
// metrics, done = 1), so a lane writes only the ticks it executes.
//
// Exactness.  Bit-identical to the JAX package's float32 tick and to the
// plain PyTorch version: built with -fmad=false (no a*b+c contraction),
// -ftz=true (subnormals flushed to zero, as XLA does) and correctly rounded
// division; every Python constant of the reference is a float literal
// applied in the reference's left-to-right order, partition sums run left
// to right, and min/max propagate NaN as XLA's do (compare and select,
// never fminf/fmaxf).  An environment's constants arrive as the float32
// rounding of the JAX package's Python double expressions.  lossy-wan's
// jitter calls the accurate libdevice sinf (no fast math), the routine
// torch.sin runs on the card; against JAX's own sin it is not bit-exact.
//
// The learned controller (KIND LEARNED; repro/learn/controller.py:125-140,
// the TPU kernel's hoisted constants).  Its MLP weights arrive as one
// float32 table (w0, b0, w1, b1, ... row-major, the layer widths in the
// argument struct); each block stages its group's table into shared memory
// once (the launch's dynamic shared memory is its largest table).
// A controller tick featurizes the interval measurement (9 features:
// clip, log1pf, log10f and divisions by the parameter row's nominal
// bandwidth, max_ch and target), runs the tanh MLP per lane with the
// hidden vector in local memory, each output summed over its inputs in
// order and the bias added last (the plain version's order), takes the
// first maximum of each head's 3 logits and applies the +/-1 steps,
// clipped.  fsm counts controller ticks.  tanhf, log1pf and log10f are
// libdevice's (no fast math).
//
// Bound.  Per lane the tick is a serial chain of ~150 dependent scalar
// float32 operations, so the kernel is latency-bound: a lane-tick costs the
// chain's latency, and only more lanes in flight hide it.  Its traffic is
// small: 28 B of traces per lane-tick written (7 x 4 B) plus the 4 B
// bandwidth share read.  The simple design does nothing yet about the
// latency (no interleaving of lanes per thread, no trimming of the chain);
// making it fast is later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tick {

constexpr int kMaxFreq = 16;
constexpr int kMaxVf = 16;
constexpr int kThreads = 32;
// The learned controller's MLP: at most kMaxLayers layers, every width at
// most kMaxWidth (a table of at most 9,545 floats, 38,180 bytes of shared
// memory), kFeatures inputs and kHeads x kClasses logits.
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 64;
constexpr int kFeatures = 9;
constexpr int kHeads = 3;
constexpr int kClasses = 3;
// np.spacing(np.finfo(np.float32).eps) = 2^-46: jnp.interp's empty step.
constexpr float kInterpDxEps = 1.4210854715202004e-14f;

enum Kind { ME = 0, EEMT = 1, EETT = 2, ISMAIL = 3, STATIC = 4, LEARNED = 5 };
enum Fsm { SLOW_START = 0, INCREASE = 1, WARNING = 2, RECOVERY = 3 };
enum Network { NET_REFERENCE = 0, NET_LOSSY_WAN = 1, NET_LOGFIT = 2 };
enum Energy { ENERGY_REFERENCE = 0, ENERGY_BIG_LITTLE = 1, ENERGY_DVFS = 2 };

struct Cpu {
  float ipc, cpb, cpb_ch, pkg_static_w, core_static_w, core_dyn_w, mem_w;
  float freq[kMaxFreq];
  int n_freq, num_cores;
};

// The environment of a group (read only when ENV is true).  The flags are
// the JAX package's Python conditionals: no min or divide without loss, no
// sin without jitter, no RTT override without a fitted RTT.
struct Env {
  int network, energy;
  int loss, jitter, fit_rtt;   // lossy-wan, lossy-wan, logfit
  int race, capped, n_vf;      // dvfs
  int n_bins;                  // logfit
  float w_loss, knee_div, jitter_rate, jitter_frac;  // lossy-wan
  float bin_s, rtt_fit;                              // logfit
  // big-little and dvfs: little_dyn / little_static are big-little's
  // little_dyn_frac / little_static_frac and dvfs's little_cap_frac /
  // little_leak_frac.
  float n_big, little_perf, little_dyn, little_static;
  float cap_nf, leak_w, leak_w_per_v, idle_leak, max_freq;  // dvfs
  float vf_f[kMaxVf], vf_v[kMaxVf];                         // dvfs V(f)
  const float* bins;           // logfit bandwidth schedule [n_bins]
};

// The learned controller's MLP shape: n_layers layers, widths[0..n_layers].
struct Mlp {
  int n_layers;
  int widths[kMaxLayers + 1];
};

// The learned controller's inputs at one controller tick.
struct Features {
  float v[kFeatures];
};

struct Args {
  const float* prow;   // [B, 13 + 5P]
  const float* bw;     // [n_steps, B]
  const float* f0;     // [B, 2P + 9]
  const int* i0;       // [B, 3]
  float* fout;         // [B, 2P + 9]
  int* iout;           // [B, 3]
  float* tput;         // [n_steps, B] each
  float* power;
  float* load;
  float* nch;
  int* cores;
  float* freq;
  int* done;
  int n_lanes, n_steps, ctrl_every;
  float dt;
  Cpu cpu;
  Env env;
  // The learned controller (KIND LEARNED only): the weight table on the
  // device, its size in floats and the MLP's shape.
  const float* policy;
  int pol_size;
  Mlp mlp;
};

// The block's copy of the learned controller's weight table.
extern __shared__ float policy_smem[];

// XLA's max/min: NaN in either operand gives NaN.
__device__ __forceinline__ float vmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float vmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return vmin(vmax(x, lo), hi);
}
__device__ __forceinline__ int clipi(int x, int lo, int hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

template <int P>
__device__ __forceinline__ float sum_lr(const float (&x)[P]) {
  float s = x[0];
#pragma unroll
  for (int p = 1; p < P; ++p) s = s + x[p];
  return s;
}

__device__ __forceinline__ float freq_at(const Cpu& c, int idx) {
  idx = clipi(idx, 0, c.n_freq - 1);
  float f = c.freq[0];
#pragma unroll
  for (int k = 1; k < kMaxFreq; ++k) f = (idx == k) ? c.freq[k] : f;
  return f;
}

// tab[k] by selects, so the by-value table stays out of local memory.
__device__ __forceinline__ float vf_at(const float (&tab)[kMaxVf], int k) {
  float v = tab[0];
#pragma unroll
  for (int j = 1; j < kMaxVf; ++j) v = (k == j) ? tab[j] : v;
  return v;
}

// jnp.interp(x, vf_f, vf_v) op for op (jax/_src/numpy/lax_numpy.py _interp;
// repro_torch.core._f32.interp_f32).
__device__ __forceinline__ float voltage(const Env& e, float x) {
  int i = 0;  // searchsorted(vf_f, x, side="right")
#pragma unroll
  for (int k = 0; k < kMaxVf; ++k) i += (k < e.n_vf && e.vf_f[k] <= x) ? 1 : 0;
  i = clipi(i, 1, e.n_vf - 1);
  const float x0 = vf_at(e.vf_f, i - 1), y0 = vf_at(e.vf_v, i - 1);
  const float df = vf_at(e.vf_v, i) - y0;
  const float dx = vf_at(e.vf_f, i) - x0;
  const float delta = x - x0;
  const bool dx0 = fabsf(dx) <= kInterpDxEps;
  float v = dx0 ? y0 : y0 + (delta / (dx0 ? 1.0f : dx)) * df;
  v = x < e.vf_f[0] ? e.vf_v[0] : v;
  return x > vf_at(e.vf_f, e.n_vf - 1) ? vf_at(e.vf_v, e.n_vf - 1) : v;
}

// sinf out of line: libdevice's accurate sinf (its Payne-Hanek slow path
// included) is emitted once for the module, not into all 64 environment
// instances.
__device__ __noinline__ float sin_out_of_line(float x) { return sinf(x); }

// torch.argmax over one head's logits: the first maximum, a NaN above all.
__device__ __forceinline__ int first_argmax(const float* v) {
  float best = v[0];
  int arg = 0;
  for (int c = 1; c < kClasses; ++c) {
    if (best == best && (v[c] > best || v[c] != v[c])) {
      best = v[c];
      arg = c;
    }
  }
  return arg;
}

// The learned controller's action class of each head for one lane, packed
// two bits a head: the MLP over the features with the block's weight
// table, each output summed over its inputs in order, the bias last, tanh
// between layers (repro_torch/learn/policy.py apply_policy), then the
// first maximum of each head's logits.  Out of line, with its arguments
// and result by value: one copy serves all the learned instances, which
// keeps the build short, and its vectors stay in its own local memory.
__device__ __noinline__ int policy_classes(const Mlp m, const Features f) {
  float x[kMaxWidth], y[kMaxWidth];
  for (int k = 0; k < kFeatures; ++k) x[k] = f.v[k];
  const float* w = policy_smem;
  for (int l = 0; l < m.n_layers; ++l) {
    const int n_in = m.widths[l], n_out = m.widths[l + 1];
    const float* bias = w + n_in * n_out;
    const bool hidden = l < m.n_layers - 1;
    for (int j = 0; j < n_out; ++j) {
      float acc = x[0] * w[j];
      for (int k = 1; k < n_in; ++k) acc = acc + x[k] * w[k * n_out + j];
      acc = acc + bias[j];
      y[j] = hidden ? tanhf(acc) : acc;
    }
    for (int j = 0; j < n_out; ++j) x[j] = y[j];
    w = bias + n_out;
  }
  int cls = 0;
  for (int h = 0; h < kHeads; ++h)
    cls |= first_argmax(x + h * kClasses) << (2 * h);
  return cls;
}

// The operating point's frequency: the ladder's, under dvfs's governor cap.
template <bool ENV>
__device__ __forceinline__ float op_freq(const Cpu& c, const Env& e,
                                         int idx) {
  const float f = freq_at(c, idx);
  if (ENV && e.energy == ENERGY_DVFS && e.capped) return vmin(f, e.max_freq);
  return f;
}

template <int P, int KIND, bool SCALING, bool ENV>
__device__ __forceinline__ void run_lane(const Args a, const int lane) {
  constexpr int NP = 13 + 5 * P;
  constexpr int NF = 2 * P + 9;
  const int B = a.n_lanes;
  const Cpu& cpu = a.cpu;
  const float dt = a.dt;

  // Parameter row: NetParams, SLAParams, then pp | par | total | avg | w.
  const float* pr = a.prow + static_cast<size_t>(lane) * NP;
  const float bandwidth = pr[0], rtt = pr[1], avg_window = pr[2];
  const float buffer = pr[3], knee = pr[4], cross = pr[5];
  const float target = pr[6], alpha = pr[7], beta = pr[8];
  const float delta_ch = pr[9], max_ch = pr[10];
  const float max_load = pr[11], min_load = pr[12];
  float pp[P], par[P], avg_file[P], static_w[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pp[p] = pr[13 + p];
    par[p] = pr[13 + P + p];
    avg_file[p] = pr[13 + 3 * P + p];
    static_w[p] = pr[13 + 4 * P + p];
  }

  // State rows.
  const float* s0 = a.f0 + static_cast<size_t>(lane) * NF;
  float rem[P], win[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    rem[p] = s0[p];
    win[p] = s0[P + p];
  }
  float t = s0[2 * P], energy = s0[2 * P + 1], bytes = s0[2 * P + 2];
  float num_ch = s0[2 * P + 3], prev_ch = s0[2 * P + 4], ref = s0[2 * P + 5];
  float acc_mb = s0[2 * P + 6], acc_j = s0[2 * P + 7], acc_s = s0[2 * P + 8];
  const int* q0 = a.i0 + static_cast<size_t>(lane) * 3;
  int fsm = q0[0], cores = q0[1], freq_idx = q0[2];

  // The environment's network numbers that hold for the whole transfer
  // (repro_torch/api/environments.py LossyWanNetworkModel.step,
  // repro_torch/workloads/logfit.py LogFitNetworkModel.step).
  const Env& env = a.env;
  float rtt_c = rtt, win_c = avg_window, knee_c = knee;
  if (ENV && env.network == NET_LOSSY_WAN && env.loss) {
    win_c = vmin(avg_window, env.w_loss);
    knee_c = knee / env.knee_div;
  }
  if (ENV && env.network == NET_LOGFIT && env.fit_rtt) rtt_c = env.rtt_fit;

  // Lane constants: the same float32 expressions the reference evaluates
  // every tick (repro/core/network_model.py:90 and :107).
  const float b_nom = bandwidth * (1.0f - cross);
  const float ramp = clip(dt / (8.0f * rtt_c), 0.0f, 1.0f);

  int i = 0;
  while (i < a.n_steps && sum_lr<P>(rem) > 0.0f) {
    const size_t o = static_cast<size_t>(i) * B + lane;
    const float bw_scale = a.bw[o];

    // This tick's environment, from the lane's time before the step: the
    // jittered RTT (and the window ramp it sets), the schedule's bandwidth.
    float rtt_t = rtt_c, bw_t = bandwidth, b_nom_t = b_nom, ramp_t = ramp;
    if (ENV && env.network == NET_LOSSY_WAN && env.jitter) {
      rtt_t = rtt_c * (1.0f + env.jitter_frac *
                                  sin_out_of_line(env.jitter_rate * t));
      ramp_t = clip(dt / (8.0f * rtt_t), 0.0f, 1.0f);
    }
    if (ENV && env.network == NET_LOGFIT) {
      const int k = clipi(static_cast<int>(floorf(t / env.bin_s)), 0,
                          env.n_bins - 1);
      bw_t = env.bins[k];
      b_nom_t = bw_t * (1.0f - cross);
    }

    // Controller channel split (repro/api/controllers.py:148-150, 195-197).
    float cc[P];
    if (KIND == ISMAIL) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        cc[p] = (static_w[p] * num_ch) * (rem[p] > 0.0f ? 1.0f : 0.0f);
    } else {  // heuristics.redistribute_channels
      float rc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) rc[p] = vmax(rem[p], 0.0f);
      const float rs = vmax(sum_lr<P>(rc), 1e-6f);
#pragma unroll
      for (int p = 0; p < P; ++p)
        cc[p] = ((rc[p] / rs) * num_ch) * (rc[p] > 0.0f ? 1.0f : 0.0f);
    }

    // Network step (repro/core/network_model.py:37-122).
    float act[P], ccn[P], wa[P], demand[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      act[p] = rem[p] > 0.0f ? 1.0f : 0.0f;
      ccn[p] = vmax(cc[p], 0.0f) * act[p];
      wa[p] = win[p] * act[p];
    }
    const float total_ch = sum_lr<P>(ccn);
    const float n_active = vmax(sum_lr<P>(act), 1.0f);
    const float avg_win = sum_lr<P>(wa) / n_active;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float hi = vmax(avg_file[p] / buffer, 1.0f);
      const float par_eff = vmin(vmax(par[p], 1.0f), hi);
      const float raw = (par_eff * win[p]) / rtt_t;
      const float per_file_s =
          avg_file[p] / vmax(raw, 1e-6f) + rtt_t / vmax(pp[p], 1.0f);
      demand[p] = ccn[p] * (avg_file[p] / vmax(per_file_s, 1e-9f));
    }
    const float total_demand = sum_lr<P>(demand);
    const float b_avail = b_nom_t * bw_scale;
    const float per_ch = vmax(avg_win / rtt_t, 1e-6f);
    const float c_sat = (knee_c * bw_t) / per_ch;
    const float over = vmax(total_ch - c_sat, 0.0f) / vmax(c_sat, 1.0f);
    const float eff = 1.0f / (1.0f + (0.5f * over) * over);
    const float net_cap = b_avail * eff;

    // Energy model (repro/core/energy_model.py:24-54; big-little:
    // repro/api/environments.py:249-313; dvfs: repro/core/dvfs.py:170-218).
    const float cf = static_cast<float>(clipi(cores, 1, cpu.num_cores));
    const float f = op_freq<ENV>(cpu, env, freq_idx);
    const float cpb = cpu.cpb + cpu.cpb_ch * total_ch;
    float big = cf, little = 0.0f, core_eff = cf;
    if (ENV && env.energy != ENERGY_REFERENCE) {
      big = vmin(cf, env.n_big);
      little = vmax(cf - env.n_big, 0.0f);
      core_eff = big + little * env.little_perf;
    }
    const float cpu_cap = (((core_eff * f) * 1e9f) * cpu.ipc) / (cpb * 1e6f);

    const float tput = vmin(vmin(total_demand, net_cap), cpu_cap);
    const float scale = tput / vmax(total_demand, 1e-6f);
    float moved[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      moved[p] = vmin((demand[p] * scale) * dt, rem[p]);
      rem[p] = rem[p] - moved[p];
      win[p] = win[p] + (win_c - win[p]) * ramp_t;
    }
    const float load = clip(tput / vmax(cpu_cap, 1e-6f), 0.0f, 1.0f);
    float pw;
    if (!ENV || env.energy == ENERGY_REFERENCE) {
      const float dyn =
          ((cf * cpu.core_dyn_w) * ((f * f) * f)) * clip(load, 0.0f, 1.0f);
      pw = ((cpu.pkg_static_w + cf * cpu.core_static_w) + dyn) +
           cpu.mem_w * tput;
    } else {
      // big-little is dvfs with V(f) = f, C_eff = core_dyn_w_per_ghz3 and
      // leakage core_static_w; (v * v) * f is then the reference's f^3.
      const float u = clip(load, 0.0f, 1.0f);
      float v = f, cap = cpu.core_dyn_w, per_core = cpu.core_static_w;
      if (env.energy == ENERGY_DVFS) {
        v = voltage(env, f);
        cap = env.cap_nf;
        per_core = env.leak_w + env.leak_w_per_v * v;
        if (env.race) per_core = per_core * (u + env.idle_leak * (1.0f - u));
      }
      const float dyn = (((big + little * env.little_dyn) * cap) *
                         ((v * v) * f)) * u;
      const float stat =
          cpu.pkg_static_w + (big + little * env.little_static) * per_core;
      pw = (stat + dyn) + cpu.mem_w * tput;
    }

    // Accumulators (repro/core/engine.py:278-303); the lane is live here.
    energy = energy + pw * dt;
    bytes = bytes + sum_lr<P>(moved);
    t = t + dt;
    acc_mb = acc_mb + tput * dt;
    acc_j = acc_j + pw * dt;
    acc_s = acc_s + dt;

    // Controller tick (repro/core/engine.py:228-242, 306-312;
    // repro/core/tuners.py:50-231; repro/core/load_control.py:20-44).
    if (KIND != STATIC && (i % a.ctrl_every) == a.ctrl_every - 1) {
      const float rs2 = sum_lr<P>(rem);
      const float win_s = vmax(acc_s, 1e-6f);
      const float avg_tput = acc_mb / win_s;
      const float avg_power = acc_j / win_s;
      const bool in_ss = fsm == SLOW_START;
      int n_fsm = INCREASE;
      float n_ch = num_ch, n_prev = prev_ch, n_ref = ref;
      if (KIND == LEARNED) {
        // repro_torch/learn/policy.py featurize, apply_policy, apply_action.
        const float bwf = vmax(bandwidth, 1e-6f);
        Features x;
        x.v[0] = clip(avg_tput / bwf, 0.0f, 2.0f);
        x.v[1] = avg_power / 40.0f;
        x.v[2] = load;
        x.v[3] = log1pf(vmax(rs2, 0.0f)) / 10.0f;
        x.v[4] = num_ch / vmax(max_ch, 1.0f);
        x.v[5] = static_cast<float>(cores) / static_cast<float>(cpu.num_cores);
        x.v[6] = static_cast<float>(freq_idx) /
                 static_cast<float>(cpu.n_freq - 1 > 1 ? cpu.n_freq - 1 : 1);
        x.v[7] = clip(target / bwf, 0.0f, 2.0f);
        x.v[8] = log10f(bwf) / 4.0f;
        const int cls = policy_classes(a.mlp, x);
        const int d_ch = (cls & 3) - 1;
        const int d_cores = ((cls >> 2) & 3) - 1;
        const int d_freq = ((cls >> 4) & 3) - 1;
        n_ch = vmin(vmax(num_ch + static_cast<float>(d_ch) * delta_ch, 1.0f),
                    max_ch);
        n_prev = num_ch;
        n_fsm = fsm + 1;
        cores = clipi(cores + d_cores, 1, cpu.num_cores);
        freq_idx = clipi(freq_idx + d_freq, 0, cpu.n_freq - 1);
      } else if (KIND == ISMAIL) {
        // Slow start only hands over to INCREASE; otherwise +/-1 channel.
        if (!in_ss) {
          const bool low = avg_tput < (1.0f - alpha) * target;
          const bool high = avg_tput > (1.0f + beta) * target;
          const float ch =
              low ? num_ch + 1.0f : (high ? num_ch - 1.0f : num_ch);
          n_ch = vmin(vmax(ch, 1.0f), max_ch);
          n_prev = num_ch;
        }
      } else {
        const float me_m =
            acc_j + avg_power * (rs2 / vmax(avg_tput, 1e-3f));
        n_prev = num_ch;
        if (in_ss) {  // Algorithm 2
          float goal = bandwidth;
          if (KIND == EETT) goal = target > 0.0f ? vmin(goal, target) : goal;
          const float corr = clip(goal / vmax(avg_tput, 1e-3f), 0.25f, 8.0f);
          n_ch = clip(num_ch * corr, 1.0f, max_ch);
          n_ref = KIND == ME ? me_m : avg_tput;
        } else if (KIND == EETT) {  // Algorithm 6
          const bool high = avg_tput > (1.0f + beta) * target;
          const bool low = avg_tput < (1.0f - alpha) * target;
          if (fsm == INCREASE) {
            n_fsm = (high || low) ? RECOVERY : INCREASE;
          } else {
            n_ch = high ? vmax(num_ch - delta_ch, 1.0f)
                        : (low ? vmin(num_ch + delta_ch, max_ch) : num_ch);
          }
          n_ref = target;
        } else {  // Algorithms 4 (ME, cost metric) and 5 (EEMT, throughput)
          const float m = KIND == ME ? me_m : avg_tput;
          const bool up = KIND == ME ? m < (1.0f - alpha) * ref
                                     : m > (1.0f + beta) * ref;
          const bool bad = KIND == ME ? m > (1.0f + beta) * ref
                                      : m < (1.0f - alpha) * ref;
          if (fsm == INCREASE) {
            n_ch = up ? vmin(num_ch + delta_ch, max_ch) : num_ch;
            n_fsm = bad ? WARNING : INCREASE;
            n_ref = KIND == ME ? m : (up ? m : ref);
          } else if (fsm == WARNING) {
            n_ch = bad ? vmax(num_ch - delta_ch, 1.0f) : num_ch;
            n_fsm = bad ? RECOVERY : INCREASE;
          } else {
            n_ch = bad ? vmin(num_ch + delta_ch, max_ch) : num_ch;
            n_ref = bad ? m : ref;
          }
        }
        if (SCALING) {  // Algorithm 3
          const int max_f = cpu.n_freq - 1;
          const bool hot = load > max_load;
          const bool cold = load < min_load;
          const bool can_add = cores < cpu.num_cores;
          const bool can_raise = freq_idx < max_f;
          const bool can_lower = freq_idx > 0;
          const bool can_drop = cores > 1;
          const int cores_hot = can_add ? cores + 1 : cores;
          const int freq_hot =
              can_add ? freq_idx : (can_raise ? freq_idx + 1 : freq_idx);
          const int freq_cold = can_lower ? freq_idx - 1 : freq_idx;
          const int cores_cold =
              can_lower ? cores : (can_drop ? cores - 1 : cores);
          const int c2 = hot ? cores_hot : (cold ? cores_cold : cores);
          const int f2 = hot ? freq_hot : (cold ? freq_cold : freq_idx);
          cores = c2;
          freq_idx = f2;
        }
      }
      fsm = n_fsm;
      num_ch = n_ch;
      prev_ch = n_prev;
      ref = n_ref;
      acc_mb = 0.0f;
      acc_j = 0.0f;
      acc_s = 0.0f;
    }

    a.tput[o] = tput;
    a.power[o] = pw;
    a.load[o] = load;
    a.nch[o] = total_ch;
    a.cores[o] = cores;
    a.freq[o] = op_freq<ENV>(cpu, env, freq_idx);
    a.done[o] = sum_lr<P>(rem) <= 0.0f ? 1 : 0;
    ++i;
  }

  float* so = a.fout + static_cast<size_t>(lane) * NF;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    so[p] = rem[p];
    so[P + p] = win[p];
  }
  so[2 * P] = t;
  so[2 * P + 1] = energy;
  so[2 * P + 2] = bytes;
  so[2 * P + 3] = num_ch;
  so[2 * P + 4] = prev_ch;
  so[2 * P + 5] = ref;
  so[2 * P + 6] = acc_mb;
  so[2 * P + 7] = acc_j;
  so[2 * P + 8] = acc_s;
  int* qo = a.iout + static_cast<size_t>(lane) * 3;
  qo[0] = fsm;
  qo[1] = cores;
  qo[2] = freq_idx;
}

// ---- launch ----------------------------------------------------------------

// The learned controller's weight table into the block's shared memory.
__device__ __forceinline__ void stage_policy(const Args& a) {
  for (int i = threadIdx.x; i < a.pol_size; i += blockDim.x)
    policy_smem[i] = a.policy[i];
  __syncthreads();
}

// One group of a launch: its arguments, its partition count, its code
// (block-uniform) and its first block in the launch.
struct Group {
  Args a;
  int p, kind, scaling, env;
  int first_block;
};

// A launch's argument: the descriptors by value, within CUDA's 32,764
// bytes of kernel parameters.
constexpr int kMaxGroups = 60;
struct GroupTable {
  int n_groups;
  Group g[kMaxGroups];
};
static_assert(sizeof(GroupTable) <= 32764,
              "the group table must fit the kernel parameter space");

template <int P, bool ENV>
__device__ __forceinline__ void run_group_lane(const Group& gr,
                                               const int lane) {
  const Args& a = gr.a;
  switch (gr.kind) {
    case ME:
      if (gr.scaling) run_lane<P, ME, true, ENV>(a, lane);
      else run_lane<P, ME, false, ENV>(a, lane);
      return;
    case EEMT:
      if (gr.scaling) run_lane<P, EEMT, true, ENV>(a, lane);
      else run_lane<P, EEMT, false, ENV>(a, lane);
      return;
    case EETT:
      if (gr.scaling) run_lane<P, EETT, true, ENV>(a, lane);
      else run_lane<P, EETT, false, ENV>(a, lane);
      return;
    case ISMAIL: run_lane<P, ISMAIL, false, ENV>(a, lane); return;
    case STATIC: run_lane<P, STATIC, false, ENV>(a, lane); return;
    case LEARNED: run_lane<P, LEARNED, false, ENV>(a, lane); return;
    default: return;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    tick_loop_grouped_kernel(const __grid_constant__ GroupTable t) {
  int g = 0;
  while (g + 1 < t.n_groups &&
         t.g[g + 1].first_block <= static_cast<int>(blockIdx.x))
    ++g;
  const Group& gr = t.g[g];
  if (gr.kind == LEARNED) stage_policy(gr.a);
  const int lane =
      (static_cast<int>(blockIdx.x) - gr.first_block) * kThreads +
      static_cast<int>(threadIdx.x);
  if (lane >= gr.a.n_lanes) return;
  if (gr.env) run_group_lane<P, true>(gr, lane);
  else run_group_lane<P, false>(gr, lane);
}

using GroupedFn = void (*)(GroupTable);

GroupedFn pick_grouped(int p) {
  switch (p) {
    case 1: return tick_loop_grouped_kernel<1>;
    case 2: return tick_loop_grouped_kernel<2>;
    case 3: return tick_loop_grouped_kernel<3>;
    case 4: return tick_loop_grouped_kernel<4>;
    case 5: return tick_loop_grouped_kernel<5>;
    case 6: return tick_loop_grouped_kernel<6>;
    case 7: return tick_loop_grouped_kernel<7>;
    case 8: return tick_loop_grouped_kernel<8>;
    default: return nullptr;
  }
}

// The arguments of one lane batch, from tick_loop_set_group's (below), or
// cudaErrorInvalidValue for an argument no instantiation takes; *generic
// says whether its blocks read the environment codes.
int make_args(int p, int kind, int scaling, const void* prow, const void* bw,
              const void* f0, const void* i0, void* fout, void* iout,
              void* tput, void* power, void* load, void* nch, void* cores,
              void* freq, void* done, int n_lanes, int n_steps,
              int ctrl_every, float dt, const float* cpu_consts, int n_freq,
              int num_cores, const int* env_codes, const float* env_consts,
              const void* env_bins, const void* policy, const int* widths,
              int n_layers, Args* out, bool* generic) {
  Env env;
  env.network = env_codes[0];
  env.energy = env_codes[1];
  env.loss = env_codes[2];
  env.jitter = env_codes[3];
  env.fit_rtt = env_codes[4];
  env.race = env_codes[5];
  env.capped = env_codes[6];
  env.n_vf = env_codes[7];
  env.n_bins = env_codes[8];
  *generic = env.network != NET_REFERENCE || env.energy != ENERGY_REFERENCE;
  if (pick_grouped(p) == nullptr || kind < ME || kind > LEARNED ||
      (scaling && kind > EETT) || n_lanes <= 0 ||
      ctrl_every <= 0 || n_freq <= 0 || n_freq > kMaxFreq ||
      env.network < 0 || env.network > 2 || env.energy < 0 ||
      env.energy > 2 ||
      (env.energy == ENERGY_DVFS && (env.n_vf < 2 || env.n_vf > kMaxVf)) ||
      (env.network == NET_LOGFIT && (env.n_bins < 1 || env_bins == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int pol_size = 0;
  if (kind == LEARNED) {
    bool ok = policy != nullptr && widths != nullptr && n_layers >= 1 &&
              n_layers <= kMaxLayers && widths[0] == kFeatures &&
              widths[n_layers] == kHeads * kClasses;
    for (int l = 0; ok && l <= n_layers; ++l)
      ok = widths[l] >= 1 && widths[l] <= kMaxWidth;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < n_layers; ++l)
      pol_size += widths[l] * widths[l + 1] + widths[l + 1];
  }
  const float* ec = env_consts;
  env.w_loss = ec[0];
  env.knee_div = ec[1];
  env.jitter_rate = ec[2];
  env.jitter_frac = ec[3];
  env.bin_s = ec[4];
  env.rtt_fit = ec[5];
  env.n_big = ec[6];
  env.little_perf = ec[7];
  env.little_dyn = ec[8];
  env.little_static = ec[9];
  env.cap_nf = ec[10];
  env.leak_w = ec[11];
  env.leak_w_per_v = ec[12];
  env.idle_leak = ec[13];
  env.max_freq = ec[14];
  for (int k = 0; k < kMaxVf; ++k) {
    env.vf_f[k] = ec[15 + k];
    env.vf_v[k] = ec[15 + kMaxVf + k];
  }
  env.bins = static_cast<const float*>(env_bins);
  Args& args = *out;
  args.prow = static_cast<const float*>(prow);
  args.bw = static_cast<const float*>(bw);
  args.f0 = static_cast<const float*>(f0);
  args.i0 = static_cast<const int*>(i0);
  args.fout = static_cast<float*>(fout);
  args.iout = static_cast<int*>(iout);
  args.tput = static_cast<float*>(tput);
  args.power = static_cast<float*>(power);
  args.load = static_cast<float*>(load);
  args.nch = static_cast<float*>(nch);
  args.cores = static_cast<int*>(cores);
  args.freq = static_cast<float*>(freq);
  args.done = static_cast<int*>(done);
  args.n_lanes = n_lanes;
  args.n_steps = n_steps;
  args.ctrl_every = ctrl_every;
  args.dt = dt;
  args.cpu.ipc = cpu_consts[0];
  args.cpu.cpb = cpu_consts[1];
  args.cpu.cpb_ch = cpu_consts[2];
  args.cpu.pkg_static_w = cpu_consts[3];
  args.cpu.core_static_w = cpu_consts[4];
  args.cpu.core_dyn_w = cpu_consts[5];
  args.cpu.mem_w = cpu_consts[6];
  for (int k = 0; k < kMaxFreq; ++k) args.cpu.freq[k] = cpu_consts[7 + k];
  args.cpu.n_freq = n_freq;
  args.cpu.num_cores = num_cores;
  args.env = env;
  args.policy = static_cast<const float*>(policy);
  args.pol_size = pol_size;
  args.mlp.n_layers = pol_size ? n_layers : 0;
  for (int l = 0; l <= kMaxLayers; ++l)
    args.mlp.widths[l] = pol_size && l <= n_layers ? widths[l] : 0;
  return 0;
}

}  // namespace tick

extern "C" {

// The C interface (loaded with ctypes).  A launch is described on the host
// first: tick_loop_set_group fills one descriptor of a buffer of
// tick_loop_group_bytes() bytes each, then tick_loop_grouped_launch
// launches the kernel once over the descriptors.
//
// tick_loop_set_group's arguments, for one lane batch of n_lanes lanes:
// `cpu_consts` is a host array: ipc, cycles_per_byte,
// cycles_per_byte_per_ch, pkg_static_w, core_static_w,
// core_dyn_w_per_ghz3, mem_w_per_mbps, then 16 frequency levels.
// `env_codes` holds network, energy, loss, jitter, fit_rtt, race, capped,
// n_vf, n_bins; `env_consts` w_loss, knee_div, jitter_rate, jitter_frac,
// bin_s, rtt_fit, n_big, little_perf, little_dyn, little_static, cap_nf,
// leak_w, leak_w_per_v, idle_leak, max_freq, then 16 V(f) frequencies and
// 16 voltages; `env_bins` is the device schedule of logfit (else null).
// The learned controller (kind 5) takes `policy`, its device weight table
// (w0, b0, w1, b1, ... row-major), and `widths`, a host array of
// n_layers + 1 layer widths (9, hidden..., 9; at most 4 layers, each width
// at most 64); other kinds ignore both.

// Bytes of one group descriptor (the buffer tick_loop_set_group fills).
int tick_loop_group_bytes() { return static_cast<int>(sizeof(tick::Group)); }

// Groups a grouped launch takes at most.
int tick_loop_max_groups() { return tick::kMaxGroups; }

// Fills descriptor `index` of the host buffer `groups`; returns 0, or
// cudaErrorInvalidValue for an argument no instantiation takes.
int tick_loop_set_group(void* groups, int index, int p, int kind,
                        int scaling, const void* prow, const void* bw,
                        const void* f0, const void* i0, void* fout,
                        void* iout, void* tput, void* power, void* load,
                        void* nch, void* cores, void* freq, void* done,
                        int n_lanes, int n_steps, int ctrl_every, float dt,
                        const float* cpu_consts, int n_freq, int num_cores,
                        const int* env_codes, const float* env_consts,
                        const void* env_bins, const void* policy,
                        const int* widths, int n_layers) {
  if (index < 0 || index >= tick::kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  tick::Group& g = static_cast<tick::Group*>(groups)[index];
  bool generic = false;
  const int err = tick::make_args(
      p, kind, scaling, prow, bw, f0, i0, fout, iout, tput, power, load, nch,
      cores, freq, done, n_lanes, n_steps, ctrl_every, dt, cpu_consts,
      n_freq, num_cores, env_codes, env_consts, env_bins, policy, widths,
      n_layers, &g.a, &generic);
  if (err != 0) return err;
  g.p = p;
  g.kind = kind;
  g.scaling = scaling;
  g.env = generic ? 1 : 0;
  g.first_block = 0;
  return 0;
}

// Launches tick_loop_grouped_kernel<p> once on `stream` over the n_groups
// descriptors that tick_loop_set_group filled, every one of partition
// count p (each group's lanes in blocks of their own, in order), and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a table it
// cannot take.
int tick_loop_grouped_launch(int p, const void* groups, int n_groups,
                             void* stream) {
  const tick::GroupedFn fn = tick::pick_grouped(p);
  if (fn == nullptr || n_groups < 1 || n_groups > tick::kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  tick::GroupTable table{};   // 31,208 bytes, copied by the launch
  table.n_groups = n_groups;
  int blocks = 0, pol_size = 0;
  for (int k = 0; k < n_groups; ++k) {
    tick::Group& g = table.g[k];
    g = static_cast<const tick::Group*>(groups)[k];
    if (g.p != p) return static_cast<int>(cudaErrorInvalidValue);
    g.first_block = blocks;
    blocks += (g.a.n_lanes + tick::kThreads - 1) / tick::kThreads;
    pol_size = g.a.pol_size > pol_size ? g.a.pol_size : pol_size;
  }
  void* params[] = {&table};
  cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks),
                   dim3(tick::kThreads), params,
                   static_cast<size_t>(pol_size) * sizeof(float),
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* tick_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
