// The recurrent policy's packed parameter layout, which the recurrent
// acting kernel (K7, act_rnn.cu) and the recurrent PPO learner (K8/K9,
// sgd_rnn.cu) share, and the cell's gate function: tanh encoder layers ->
// GRU or LSTM cell -> fused logits + value head, in flax's cell math
// (warehouse_tpu/pallas/act.py:522-526):
//
//   GRU:  r = sig(Wir e + bir + Whr h); z = sig(Wiz e + biz + Whz h);
//         q = Whn h + bhn; n = tanh(Win e + bin + r q); h' = (1-z) n + z h.
//   LSTM: i, f, o = sig(Wi* e + Wh* h + bh*); g = tanh(Wig e + Whg h + bhg);
//         c' = f c + i g; h' = o tanh(c').
//
// The packed parameter vector (float32; every W is [out, in], torch's
// layout):
//   per encoder layer W [E_l, in], b [E_l];
//   Wi [G H, E]   the input-side gate kernels stacked (GRU ir, iz, in;
//                 LSTM ii, if, ig, io), G = 3 or 4;
//   GRU only: bi [3 H];
//   Wh [G H, H]   the recurrent gate kernels stacked (hr, hz, hn; hi, hf,
//                 hg, ho);
//   bh            GRU: bhn [H]; LSTM: [4 H];
//   head W [6, H] (5 logits, then the value), b [6].
//
// No kernel reads this vector in its products, and no TPU kernel is
// replaced here: each kernel lays it out as its own tiles read it. K7's
// prep (act_rnn.cu) writes the cell's gate kernels as one Bt over [e | h]
// with the gates interleaved, for its cell stage on the tensor cores
// (3xTF32, kept over FFMA register blocks: faster, within every K7 bound;
// bound by its products); K8/K9's (sgd_rnn.cu) write theirs for the
// learner's stages. The CNN layout (cnn_net.cuh) takes RHEAD from here.
//
// Any width and any number of encoder layers: the per-layer tables live in
// the caller's RnnTables on the host, and no kernel reads them.
#pragma once

#include <cuda_runtime.h>

#include <vector>

#include "host_ptr.cuh"

namespace {

constexpr int RHEAD = 6;   // 5 logits + value

// Host storage of the per-layer tables of RnnNet and of K7's and K8/K9's
// layouts.
struct RnnTables {
  std::vector<int> enc_in, enc_out;
  std::vector<long> enc_w, enc_b;
  std::vector<int> ld, hp;    // K7 (act_rnn.cu RnnLayout)
  std::vector<long> bt;
  std::vector<int> Es, Ks;    // K8/K9 (sgd_rnn.cu RDims, RnnScratch)
  std::vector<float*> encp, enct, act, dz;
};

struct RnnNet {
  int n_enc, D, E, H, lstm, G;
  HostPtr<const int> enc_in, enc_out;  // one per encoder layer
  HostPtr<const long> enc_w, enc_b;
  long wi, bi;  // bi < 0 for the LSTM (no input-side bias)
  long wh, bh;  // bh: GRU [H] (hn's), LSTM [4 H]
  long head_w, head_b;
  long n_params;
};

// dims = obs width, then the encoder widths; the tables in *tb.
inline bool make_rnn_net(int n_enc, const int* dims, int H, int lstm,
                         RnnNet* net, RnnTables* tb) {
  if (n_enc < 1 || H <= 0) return false;
  net->n_enc = n_enc;
  net->D = dims[0];
  net->H = H;
  net->lstm = lstm ? 1 : 0;
  net->G = lstm ? 4 : 3;
  tb->enc_in.assign(n_enc, 0);
  tb->enc_out.assign(n_enc, 0);
  tb->enc_w.assign(n_enc, 0);
  tb->enc_b.assign(n_enc, 0);
  net->enc_in = tb->enc_in.data();
  net->enc_out = tb->enc_out.data();
  net->enc_w = tb->enc_w.data();
  net->enc_b = tb->enc_b.data();
  long off = 0;
  for (int l = 0; l < n_enc; ++l) {
    const int in = dims[l], out = dims[l + 1];
    if (in <= 0 || out <= 0) return false;
    tb->enc_in[l] = in;
    tb->enc_out[l] = out;
    tb->enc_w[l] = off;
    tb->enc_b[l] = off + (long)in * out;
    off = tb->enc_b[l] + out;
  }
  const int E = net->E = dims[n_enc], G = net->G;
  net->wi = off;
  off += (long)G * H * E;
  net->bi = lstm ? -1 : off;
  if (!lstm) off += 3 * H;
  net->wh = off;
  off += (long)G * H * H;
  net->bh = off;
  off += lstm ? 4 * H : H;
  net->head_w = off;
  off += (long)RHEAD * H;
  net->head_b = off;
  net->n_params = off + RHEAD;
  return true;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace
