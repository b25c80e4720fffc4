"""VSLNet assembly, the counterpart of the JAX package's models/vslnet.py
(GloVe + char-CNN text encoder).

    word emb (frozen GloVe + UNK) ++ char-CNN  ->  conv1d -> hidden
    video feats -> dropout -> conv1d -> hidden
    one shared FeatureEncoder on both streams
    context-query attention -> query-pooled concat
    highlight head; features gated by the sigmoid scores
    conditioned predictor (rnn | transformer) -> start/end logits

Training mode with drop_rate > 0 is the JAX package's
`deterministic=False`: dropout at its sites, every mask drawn from the
caller's torch.Generator (models/layers.py). Eval mode is serving.
"""
import torch
from torch import nn

from vslnet_torch.config import resolve_device, use_kernels
from vslnet_torch.models.layers import (
    CharEmbedding,
    ConditionedPredictor,
    Conv1D,
    CQAttention,
    CQConcat,
    FeatureEncoder,
    HighlightLayer,
    WordEmbedding,
    dropout,
    glorot_,
)
from vslnet_torch.ops.masking import sequence_mask


class VSLNet(nn.Module):
    def __init__(self, hidden_size=128, char_size=100, char_dim=50,
                 video_feature_dim=1024, num_heads=8, max_pos_len=128,
                 predictor="rnn", word_vectors_shape=(100, 300), cqa_bias=False,
                 use_kernels=False):
        super().__init__()
        self.word_embeddings = WordEmbedding(word_vectors_shape)
        self.char_embeddings = CharEmbedding(char_size, char_dim)
        self.video_conv1d = Conv1D(video_feature_dim, hidden_size, use_bias=True)
        self.query_conv1d = Conv1D(
            word_vectors_shape[1] + self.char_embeddings.out_dim, hidden_size,
            use_bias=True)
        self.feature_encoder = FeatureEncoder(
            hidden_size, num_heads, max_pos_len, use_kernels)
        self.video_query_attention = CQAttention(hidden_size, cqa_bias,
                                                 use_kernels)
        self.context_query_concat = CQConcat(hidden_size)
        self.highlighting_layer = HighlightLayer(hidden_size, use_kernels)
        self.conditioned_predictor = ConditionedPredictor(
            hidden_size, num_heads, max_pos_len, predictor, use_kernels)

    def forward(self, word_ids, char_ids, vfeats, v_len, drop_rate=0.0,
                generator=None):
        """drop_rate acts in training mode only; it needs `generator`, a
        torch.Generator on the inputs' device."""
        drop = (drop_rate if self.training else 0.0, generator)
        if drop[0] > 0.0 and generator is None:
            raise ValueError("drop_rate > 0 in training mode needs a "
                             "torch.Generator on the inputs' device")
        T = vfeats.shape[1]
        v_mask = sequence_mask(v_len, T)
        q_mask = (word_ids != 0).to(torch.int32)
        query = torch.cat([self.word_embeddings(word_ids, *drop),
                           self.char_embeddings(char_ids, *drop)], dim=-1)
        video = self.video_conv1d(dropout(vfeats.to(torch.float32), *drop))
        query = self.query_conv1d(query)
        video = self.feature_encoder(video, v_mask, *drop)
        query = self.feature_encoder(query, q_mask, *drop)
        feats, vq_score = self.video_query_attention(video, query, v_mask,
                                                     q_mask, *drop)
        feats = self.context_query_concat(feats, query, q_mask)
        h_logits, h_scores, gated = self.highlighting_layer(feats, v_mask)
        feats = feats * h_scores[:, :, None] if gated is None else gated
        start_logits, end_logits = self.conditioned_predictor(
            feats, v_len, v_mask, *drop)
        return {
            "start_logits": start_logits,
            "end_logits": end_logits,
            "highlight_logits": h_logits,
            "highlight_scores": h_scores,
            "vq_score": vq_score,
            "v_mask": v_mask,
            "q_mask": q_mask,
        }


def init_weights(model, seed):
    """flax's initializers, from a seeded torch.Generator: LayerNorm scales
    ones, biases zeros, every other parameter glorot-uniform."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias" or leaf.startswith("bias_"):
                p.zero_()
            else:
                glorot_(p, gen)


def build_model(configs, word_vectors_shape, device=None):
    """The VSLNet of `configs` on `device` (default: the CUDA card; raises
    without one), seeded from configs.seed, in eval mode. The kernels are
    used unless configs.use_pallas is off (see config.use_kernels)."""
    device = resolve_device(device)
    if configs.precision != "fp32":
        raise NotImplementedError(
            "precision=%s: only fp32 is ported; bf16 kernels are queued in "
            "ROADMAP.md" % configs.precision)
    if configs.text_encoder != "glove":
        raise NotImplementedError(
            "text_encoder=%s: only glove is ported; BERT is queued in "
            "ROADMAP.md" % configs.text_encoder)
    if str(configs.ring_attention).lower() in ("on", "true", "1", "yes"):
        raise NotImplementedError(
            "ring attention is not ported (one device); see ROADMAP.md")
    if configs.char_size is None:
        raise ValueError("configs.char_size is unset: set it from the "
                         "dataset's n_chars")
    model = VSLNet(
        hidden_size=configs.hidden_size, char_size=configs.char_size,
        char_dim=configs.char_dim, video_feature_dim=configs.video_feature_dim,
        num_heads=configs.num_heads, max_pos_len=configs.max_pos_len,
        predictor=configs.predictor,
        word_vectors_shape=tuple(word_vectors_shape),
        cqa_bias=bool(configs.cqa_bias),
        use_kernels=use_kernels(configs),
    )
    init_weights(model, configs.seed)
    return model.to(device).eval()
