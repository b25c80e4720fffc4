"""VSLNet building blocks as PyTorch modules, the counterparts of the JAX
package's models/layers.py (TF-reference semantics: LayerNorm eps 1e-6,
multiplicative -1e30 masks, attention without an output projection, one
FeatureEncoder shared by video and query, TF LSTMCell gates).

Parameters keep the flax names and layouts (`Conv1D.kernel` [in, out], the
LSTM's one [in+H, 4H] `kernel`, `depthwise_filter` [k, 1, D, 1],
`pointwise_filter` [1, 1, D, D], char filters [1, k, D, C]), so
convert_flax.py is a name map and the kernels take the JAX argument
layouts.

ConvBlock, MultiHeadAttentionBlock, CQAttention, HighlightLayer and
LSTMEncoder call the kernel wrappers of ops/kernels.py when built with
`use_kernels` (every `use_pallas` but off), and the kernels' plain versions
otherwise. A wrapper launches its CUDA kernel for tensors on the card and
runs the plain version for tensors on the CPU, so the choice of device is
made at each call, never when the module is built; on the card the conv
and MHA block wrappers also pick their kernels from the shape (the conv
block takes its tiled kernels from T = 24 when serving, 48 when training,
by measurement; T above 145 at hidden 128 takes fused_mha's whole-T or
flash kernels; ops/kernels.py conv_route, mha_route). As in the JAX package,
CQAttention's kernel path returns no score and HighlightLayer's no logits,
and both take their kernels only when deterministic: here, in eval mode.

Dropout (training mode, drop_rate > 0) follows the JAX package's sites.
Where the JAX package uses flax's nn.Dropout (embeddings, video features,
the CQA score inputs), `dropout` draws its mask from an explicit
torch.Generator. The conv and MHA blocks draw per-row seeds from the same
generator and drop by the counter hash, in their kernels and in their
plain versions alike.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from vslnet_torch.ops import kernels
from vslnet_torch.ops.masking import mask_logits


def glorot_(param, generator):
    """flax's glorot_uniform: fans over the last two axes, times the
    receptive field of the others."""
    shape = param.shape
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        param.copy_(torch.rand(shape, generator=generator) * (2 * limit)
                    - limit)


def _param(*shape):
    return nn.Parameter(torch.zeros(*shape))


def dropout(x, rate, generator):
    """Inverted dropout with its mask drawn from `generator` (on x's
    device); x itself at rate 0."""
    if rate <= 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep * (1.0 / (1.0 - rate))


def draw_seeds(generator, batch, rate):
    """Per-row counter-hash seeds [B, 1], float32 holding integers in
    [0, 2^23) as the JAX package draws them; None at rate 0."""
    if rate <= 0.0:
        return None
    return torch.randint(0, 1 << 23, (batch, 1), generator=generator,
                         device=generator.device).to(torch.float32)


class LayerNorm(nn.Module):
    def __init__(self, dim, epsilon=1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = _param(dim)

    def forward(self, x):
        return kernels.layer_norm(x, self.scale, self.bias, self.epsilon)


class Conv1D(nn.Module):
    """Kernel-size-1 conv == position-wise linear; kernel [in, out]."""

    def __init__(self, in_dim, dim, use_bias=False, activation=None):
        super().__init__()
        self.kernel = _param(in_dim, dim)
        self.bias = _param(dim) if use_bias else None
        self.activation = activation

    def forward(self, x):
        y = x @ self.kernel
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y


class WordEmbedding(nn.Module):
    """Frozen GloVe rows (a buffer, not a parameter) + trainable UNK + a
    fixed zero PAD row; table order [zero, unk, glove] matches PAD=0,
    UNK=1."""

    def __init__(self, vectors_shape):
        super().__init__()
        n, dim = vectors_shape
        self.register_buffer("word_vectors", torch.zeros(n, dim))
        self.unk = _param(1, dim)

    def forward(self, word_ids, drop_rate=0.0, generator=None):
        table = torch.cat([self.unk.new_zeros(1, self.unk.shape[1]), self.unk,
                           self.word_vectors])
        return dropout(F.embedding(word_ids.long(), table),
                       drop_rate if self.training else 0.0, generator)


class CharEmbedding(nn.Module):
    """Char-CNN: [char_size-1, dim] table + zero PAD row, VALID convs of
    widths 1-4 with 10/20/30/40 channels, ReLU, max over the chars."""

    def __init__(self, char_size, dim, kernels_=(1, 2, 3, 4),
                 filters=(10, 20, 30, 40)):
        super().__init__()
        self.kernel_sizes = tuple(kernels_)
        self.char_table = _param(char_size - 1, dim)
        for i, (k, ch) in enumerate(zip(kernels_, filters)):
            self.register_parameter("filter_%d" % i, _param(1, k, dim, ch))
            self.register_parameter("bias_%d" % i, _param(ch))
        self.out_dim = sum(filters)

    def forward(self, char_ids, drop_rate=0.0, generator=None):
        B, W, C = char_ids.shape
        table = torch.cat([self.char_table.new_zeros(1, self.char_table.shape[1]),
                           self.char_table])
        x = dropout(F.embedding(char_ids.long(), table),
                    drop_rate if self.training else 0.0, generator)
        x = x.reshape(B * W, C, -1)
        x = x.transpose(1, 2)  # [B*W, dim, C]
        outs = []
        for i in range(len(self.kernel_sizes)):
            weight = getattr(self, "filter_%d" % i)[0].permute(2, 1, 0)
            y = F.conv1d(x, weight, getattr(self, "bias_%d" % i))
            outs.append(torch.relu(y).amax(dim=2).reshape(B, W, -1))
        return torch.cat(outs, dim=-1)


class PositionalEmbedding(nn.Module):
    def __init__(self, max_position_length, dim):
        super().__init__()
        self.position_embeddings = _param(max_position_length, dim)

    def forward(self, x):
        T = x.shape[-2]
        if T > self.position_embeddings.shape[0]:
            raise ValueError("sequence length %d exceeds max_pos_len %d"
                             % (T, self.position_embeddings.shape[0]))
        return x + self.position_embeddings[:T]


class DepthwiseSeparableConv(nn.Module):
    """Depthwise (k along T, SAME) + pointwise conv, bias, ReLU."""

    def __init__(self, kernel_size, in_dim, dim):
        super().__init__()
        self.depthwise_filter = _param(kernel_size, 1, in_dim, 1)
        self.pointwise_filter = _param(1, 1, in_dim, dim)
        self.bias = _param(dim)

    def kernel_params(self):
        """(dw [k, D], wp [D, D], bias [D]) in the kernels' layout."""
        return (self.depthwise_filter[:, 0, :, 0], self.pointwise_filter[0, 0],
                self.bias)

    def forward(self, x):
        return kernels.depthwise_separable(x, *self.kernel_params())


class ConvBlock(nn.Module):
    """num_layers x {pre-LN -> depthwise-separable conv -> dropout ->
    +residual}."""

    def __init__(self, kernel_size, dim, num_layers, use_kernels=False):
        super().__init__()
        self.num_layers = num_layers
        self.use_kernels = use_kernels
        for l in range(num_layers):
            self.add_module("layer_norm_%d" % l, LayerNorm(dim))
            self.add_module("depthwise_conv_layers_%d" % l,
                            DepthwiseSeparableConv(kernel_size, dim, dim))

    def stacked_params(self):
        """gam, beta, bp [L, D], dw [L, k, D], wp [L, D, D]."""
        lns = [getattr(self, "layer_norm_%d" % l) for l in range(self.num_layers)]
        convs = [getattr(self, "depthwise_conv_layers_%d" % l).kernel_params()
                 for l in range(self.num_layers)]
        return (torch.stack([ln.scale for ln in lns]),
                torch.stack([ln.bias for ln in lns]),
                torch.stack([c[0] for c in convs]),
                torch.stack([c[1] for c in convs]),
                torch.stack([c[2] for c in convs]))

    def forward(self, x, drop_rate=0.0, generator=None):
        rate = drop_rate if self.training else 0.0
        seeds = draw_seeds(generator, x.shape[0], rate)
        if self.use_kernels:
            return kernels.fused_conv_block(x.contiguous(), *self.stacked_params(),
                                            seeds=seeds, drop_rate=rate)
        return kernels.conv_block_plain(x, *self.stacked_params(), seeds=seeds,
                                        drop_rate=rate)


class MultiHeadAttention(nn.Module):
    """QKV conv1d projections with bias, 1/sqrt(head) scaling, additive
    -1e30 key mask, fp32 softmax, head merge. No output projection."""

    def __init__(self, dim, num_heads):
        super().__init__()
        if dim % num_heads:
            raise ValueError("The hidden size (%d) is not a multiple of the "
                             "attention heads (%d)" % (dim, num_heads))
        self.num_heads = num_heads
        self.query = Conv1D(dim, dim, use_bias=True)
        self.key = Conv1D(dim, dim, use_bias=True)
        self.value = Conv1D(dim, dim, use_bias=True)

    def qkv_params(self):
        """wqkv [D, 3D] = [Wq | Wk | Wv] and bqkv [3D]."""
        return (torch.cat([self.query.kernel, self.key.kernel,
                           self.value.kernel], dim=1),
                torch.cat([self.query.bias, self.key.bias, self.value.bias]))

    def forward(self, x, mask):
        return kernels.attention(self.query(x), self.key(x), self.value(x),
                                 mask, self.num_heads)


class MultiHeadAttentionBlock(nn.Module):
    """Pre-LN attention + 1-layer dense block, dropout at the JAX sites:
    res = drop(MHA(drop(LN1(x)))) + x;  out = drop(dense(drop(LN2(res)))) +
    res, and on the attention probabilities."""

    def __init__(self, dim, num_heads, use_kernels=False):
        super().__init__()
        self.use_kernels = use_kernels
        self.num_heads = num_heads
        self.layer_norm_1 = LayerNorm(dim)
        self.multihead_attention = MultiHeadAttention(dim, num_heads)
        self.layer_norm_2 = LayerNorm(dim)
        self.dense = Conv1D(dim, dim, use_bias=True)

    def forward(self, x, mask, drop_rate=0.0, generator=None):
        gam = torch.stack([self.layer_norm_1.scale, self.layer_norm_2.scale])
        beta = torch.stack([self.layer_norm_1.bias, self.layer_norm_2.bias])
        wqkv, bqkv = self.multihead_attention.qkv_params()
        rate = drop_rate if self.training else 0.0
        args = (mask.to(torch.float32), gam, beta, wqkv, bqkv,
                self.dense.kernel, self.dense.bias, self.num_heads)
        kw = {"seeds": draw_seeds(generator, x.shape[0], rate),
              "drop_rate": rate}
        if self.use_kernels:
            return kernels.fused_mha_block(x.contiguous(), *args, **kw)
        return kernels.mha_block_plain(x, *args, **kw)


class FeatureEncoder(nn.Module):
    """posemb -> conv block -> MHA block. One instance serves both the video
    and the query stream (shared weights)."""

    def __init__(self, hidden_size, num_heads, max_position_length,
                 use_kernels=False):
        super().__init__()
        self.positional_embedding = PositionalEmbedding(max_position_length,
                                                        hidden_size)
        self.conv_block = ConvBlock(7, hidden_size, 4, use_kernels)
        self.multihead_attention_block = MultiHeadAttentionBlock(
            hidden_size, num_heads, use_kernels)

    def forward(self, x, mask, drop_rate=0.0, generator=None):
        x = self.conv_block(self.positional_embedding(x), drop_rate, generator)
        return self.multihead_attention_block(x, mask, drop_rate, generator)


class CQAttention(nn.Module):
    """Context-query attention with the low-rank trilinear score
    S = v.w0 + (q.w1)^T + (v*w_mul) q^T, masked row/col softmaxes, v2q and
    q2v, 4-way concat -> conv1d (no bias, TF parity; t7 dialect: bias).
    Returns (output, score); the kernel path (eval mode only, as the JAX
    package takes it only when deterministic) returns no score. In
    training the score's inputs are dropped."""

    def __init__(self, dim, out_bias=False, use_kernels=False):
        super().__init__()
        self.use_kernels = use_kernels
        self.linear_kernel4arg0 = _param(dim, 1)
        self.linear_kernel4arg1 = _param(dim, 1)
        self.linear_kernel4mul = _param(1, 1, dim)
        self.dense = Conv1D(4 * dim, dim, use_bias=out_bias)

    def forward(self, video, query, v_mask, q_mask, drop_rate=0.0,
                generator=None):
        v_mask = v_mask.to(torch.float32)
        q_mask = q_mask.to(torch.float32)
        weights = (self.linear_kernel4arg0[:, 0], self.linear_kernel4arg1[:, 0],
                   self.linear_kernel4mul[0, 0])
        if self.use_kernels and not self.training:
            out = kernels.fused_cqa_concat(video.contiguous(),
                                           query.contiguous(), v_mask, q_mask,
                                           *weights)
            return self.dense(out), None
        rate = drop_rate if self.training else 0.0
        score = kernels.trilinear_score(dropout(video, rate, generator),
                                        dropout(query, rate, generator),
                                        *weights)
        out = kernels.cqa_from_score(score, video, query, v_mask, q_mask)
        return self.dense(out), score


class CQConcat(nn.Module):
    """Attention-pooled query, tiled over T, concat, conv1d."""

    def __init__(self, dim):
        super().__init__()
        self.weight = _param(dim, 1)
        self.dense = Conv1D(2 * dim, dim, use_bias=True)

    def forward(self, x, qfeats, q_mask):
        logits = mask_logits(qfeats @ self.weight, q_mask[:, :, None])
        alphas = torch.softmax(logits, dim=1)                    # [B, W, 1]
        pooled = (qfeats * alphas).sum(dim=1)                    # [B, d]
        tiled = pooled[:, None, :].expand(-1, x.shape[1], -1)
        return self.dense(torch.cat([x, tiled], dim=-1))


class HighlightLayer(nn.Module):
    """Per-frame logit head: (masked logits, sigmoid scores, None); the
    kernel path (eval mode only: training needs the logits) fuses the
    feature gate x * scores and returns (None, scores, gated x)."""

    def __init__(self, dim, use_kernels=False):
        super().__init__()
        self.use_kernels = use_kernels
        self.dense = Conv1D(dim, 1, use_bias=True)

    def forward(self, x, v_mask):
        args = (self.dense.kernel[:, 0], self.dense.bias,
                v_mask.to(torch.float32))
        if self.use_kernels and not self.training:
            gated, scores = kernels.fused_highlight_gate(x.contiguous(), *args)
            return None, scores, gated
        logits, scores = kernels.highlight_plain(x, *args)
        return logits, scores, None


class LSTMEncoder(nn.Module):
    """Unidirectional LSTM with TF LSTMCell semantics: gates [i, j, f, o],
    forget bias 1.0; outputs zeroed and state frozen past each row's
    seq_len (tf.nn.dynamic_rnn). The input projection for all steps is one
    matmul; the recurrence is the kernel (or its plain version)."""

    def __init__(self, in_dim, dim, use_kernels=False):
        super().__init__()
        self.in_dim = in_dim
        self.use_kernels = use_kernels
        self.kernel = _param(in_dim + dim, 4 * dim)
        self.bias = _param(4 * dim)

    def forward(self, x, seq_len):
        B, T, _ = x.shape
        k_x, k_h = self.kernel[:self.in_dim], self.kernel[self.in_dim:]
        xs = (x @ k_x + self.bias).transpose(0, 1).contiguous()  # [T, B, 4H]
        pos = torch.arange(T, device=x.device)
        valid = (pos[:, None] < seq_len[None, :]).to(torch.float32)  # [T, B]
        if self.use_kernels:
            ys = kernels.fused_lstm_recurrence(xs, k_h.contiguous(), valid)
        else:
            ys = kernels.lstm_recurrence_plain(xs, k_h, valid)
        return ys.transpose(0, 1)


class ConditionedPredictor(nn.Module):
    """Span heads. `rnn`: two stacked LSTMs (start feeds end).
    `transformer`: one FeatureEncoder applied twice + start/end LNs. Both:
    concat with the input -> ReLU conv -> 1-logit conv -> mask."""

    def __init__(self, hidden_size, num_heads, max_position_length,
                 mode="rnn", use_kernels=False):
        super().__init__()
        if mode not in ("rnn", "transformer"):
            raise ValueError("predictor must be rnn or transformer, got %r"
                             % (mode,))
        self.mode = mode
        if mode == "rnn":
            self.start_rnn = LSTMEncoder(hidden_size, hidden_size, use_kernels)
            self.end_rnn = LSTMEncoder(hidden_size, hidden_size, use_kernels)
        else:
            self.feature_encoder = FeatureEncoder(
                hidden_size, num_heads, max_position_length, use_kernels)
            self.s_layer_norm = LayerNorm(hidden_size)
            self.e_layer_norm = LayerNorm(hidden_size)
        self.start_hidden = Conv1D(2 * hidden_size, hidden_size, True, torch.relu)
        self.end_hidden = Conv1D(2 * hidden_size, hidden_size, True, torch.relu)
        self.start_dense = Conv1D(hidden_size, 1, use_bias=True)
        self.end_dense = Conv1D(hidden_size, 1, use_bias=True)

    def forward(self, x, seq_len, v_mask, drop_rate=0.0, generator=None):
        if self.mode == "rnn":
            start_features = self.start_rnn(x, seq_len)
            end_features = self.end_rnn(start_features, seq_len)
        else:
            start_features = self.feature_encoder(x, v_mask, drop_rate,
                                                  generator)
            end_features = self.feature_encoder(start_features, v_mask,
                                                drop_rate, generator)
            start_features = self.s_layer_norm(start_features)
            end_features = self.e_layer_norm(end_features)
        start = self.start_hidden(torch.cat([start_features, x], dim=-1))
        end = self.end_hidden(torch.cat([end_features, x], dim=-1))
        start_logits = mask_logits(self.start_dense(start).squeeze(-1), v_mask)
        end_logits = mask_logits(self.end_dense(end).squeeze(-1), v_mask)
        return start_logits, end_logits
