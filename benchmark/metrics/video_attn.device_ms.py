"""Device milliseconds a traced train step in the kernels that compute
the video tower's scaled dot-product attention, forward and backward:
the device time of every op whose name holds one of ``FRAGMENTS``, over
the traced steps. The fragments name the kernels of the backends that
``torch.nn.functional.scaled_dot_product_attention`` runs on the card.
On the H100 with torch 2.11 both of TimeSformer's attentions (8 and 197
tokens, 64 a head, bf16) ran on cuDNN's fused graphs:
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_...`` and
``..._flash_bprop_wgmma_f16_...``, with the backward's helpers
``cudnn::fusion::compute_dot_do_o_specialized`` and
``cudnn::fusion::convert_dq_to_16bits``; the other backends' kernels are
flash attention's ``flash_fwd``/``flash_bwd`` and the memory-efficient
``fmha_cutlass``. A run whose program did not count ``video.attn_calls``
in its traced part has no such tower and reads nothing."""

from benchmark import spans

FRAGMENTS = ("_native_sdpa_", "cudnn::fusion::compute_dot_do_o",
             "cudnn::fusion::convert_dq", "flash_fwd", "flash_bwd",
             "fmha_cutlass")


def read(run):
    s = spans.of(run, "pretrain")
    if s is None or not s[1].get("video.attn_calls") or not run.traced_steps:
        return None
    total = sum(sec for name, (_, sec) in run.summary["device_by_name"].items()
                if any(f in name for f in FRAGMENTS))
    return 1e3 * total / run.traced_steps
