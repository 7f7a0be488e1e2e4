"""How far each attention kernel may sit from its plain version.

Per kernel and exp backend: (largest |kernel - plain|, share of outputs
whose bits differ), both over the same inputs on the card. ``chip_smoke.py``
holds every attention kernel to them, and the CPU tests hold their
emulations of faulty kernels outside them.

A kernel sums its f32 dot products in another order than the plain
version; that moves an f32 result by ulps, which after the round to the
bf16 output flips a few outputs by one bf16 ulp. The card's readings at
the smoke inputs (PERF.md, exact / vexp / vexp_hw): FA on the CUDA-core
kernel, cold, max 1.95e-3 / 2.0e-3 / 0 and share 3.3e-6 / 4.4e-6 / 0;
its hot and D = 32 cases share 3.4-6.8e-6 (PERF.md gives no newer max
for them). So FA's exact max sits just inside its 2e-3 limit: 1.95e-3
is one bf16 ulp on an output in [0.25, 0.5). The split decode sweep
max 6.1e-5 / 4.9e-4 / 7.5e-9 and share 1.3e-3 / 6.5e-4 / 1.6e-4 (one
output in 6,144); the decode limits sit 2-4x above them, and at 1e-6
where the reading is 0 or 7.5e-9.

Each kernel phase also holds the plain version at half the online-update
block against the one at the full block, and a kernel with that wrong
partition must fail these limits. Under vexp the max alone cannot see it
(the half block moves outputs by at most 2e-3, inside the limit); the
share can: the half block changes 3-5 % (FA) and 19-22 % (decode) of the
outputs. The FA limits admit no summation order but the plain version's
own: the plain version computed on the host moves 1.2e-4 of the outputs
against itself on the card, and a tensor-core kernel with every product
exact moved 2-7e-4 of them (PERF.md). The scan with p in two bf16 terms
(an under-split tensor-core kernel) must fail them too.

FA under the exact exp admits a one-ulp flip at any magnitude
(``ONE_ULP_FREE``): its max bounds only the outputs that moved by more
than one bf16 ulp, so an output is inside when it is within max(2e-3,
one bf16 ulp of the plain output). The absolute max alone admitted a
flip only below |o| = 0.5, a matter of the inputs' size, not of the
kernel: at the training step's shape (B 8, S 1,024, 12 causal heads of
64) one flipped output of 33 sat in [0.5, 1), 3.9e-3 off (PERF.md). The
share still bounds how many flip, and every output at the smoke shapes
stays within one ulp or 2e-3, as before.
"""

import torch

ATT_LIMITS = {
    "flash_attention": {"exact": (2e-3, 3e-5), "vexp": (8e-3, 3e-5),
                        "vexp_hw": (1e-6, 1e-5)},
    "decode_attention": {"exact": (1.5e-4, 5e-3), "vexp": (1e-3, 5e-3),
                         "vexp_hw": (1e-6, 1e-3)},
    # paged decode, read on the card (PERF.md): max 2.4e-4 / 1.2e-4 / 0
    # and share 6.5e-4 / 1.6e-4 / 0 (4 and 1 outputs of 6,144 moved by
    # one bf16 ulp). The exact limit allows such a flip at |o| ~ 0.25.
    # The plain version at half a page moves 23-28 % of the outputs, by
    # up to 3.9e-3, and must fail them: that shows the kernel updates
    # once per page.
    "decode_attention_paged": {"exact": (1e-3, 5e-3),
                               "vexp": (1e-3, 5e-3),
                               "vexp_hw": (1e-6, 1e-3)},
    # the sequence-sharded kernels, each shard's statistics normalized on
    # their own, live rows only. The paged ones (B8, B9) stay inside the
    # paged limits: max 4.9e-4 / 4.9e-4 / 6e-8, share 6.5e-4 / 3.7e-4 /
    # 5.9e-5 at 2 and 4 shards, both layouts. The contiguous ones (B5,
    # B6) read max 9.8e-4 / 6.1e-5 / 9.8e-4 and share 9.3e-4 / 5.9e-5 /
    # 1.1e-3: a shard's output normalizes over fewer keys than the whole
    # row's, so it is larger, and the one-ulp bf16 flips that summation
    # order causes cost up to 2^-10 (the decode limits' exact 1.5e-4 and
    # vexp_hw 1e-6 sit below one such flip at |o| > 1/64). These limits
    # take one flip at |o| < 0.5 and twice the share read; the plain
    # version at half a block still moves 13-21 % of the outputs and
    # fails them.
    "decode_attention_partial": {"exact": (2e-3, 5e-3),
                                 "vexp": (1e-3, 5e-3),
                                 "vexp_hw": (2e-3, 3e-3)},
}

# (kernel, exp backends) whose max counts only outputs more than one bf16
# ulp from the plain version's (``beyond_one_ulp``)
ONE_ULP_FREE = {"flash_attention": ("exact",)}


def beyond_one_ulp(out, ref) -> float:
    """Largest |out - ref| over the outputs more than one bf16 ulp from
    ``ref`` (0.0 where none is): two bf16 values of one sign one ulp
    apart differ by one in their 16-bit patterns. Other dtypes: the
    largest |out - ref|."""
    diff = (out.float() - ref.float()).abs()
    if out.dtype == ref.dtype == torch.bfloat16:
        steps = (out.view(torch.int16).int()
                 - ref.view(torch.int16).int()).abs()
        diff = diff[steps > 1]
    return float(diff.max()) if diff.numel() else 0.0

