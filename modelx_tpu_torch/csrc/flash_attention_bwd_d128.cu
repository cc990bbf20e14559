// The bf16 backward's tensor-core kernel at head_dim 128: flash_attention_bwd.cu's
// flash_bwd_wgmma<128> and its launcher (mx::launch_bwd_wgmma<128>) in a
// translation unit of their own, so that nvcc compiles the head dims side
// by side. flash_attention_bwd.cu's C entry reaches it.

#define MX_BWD_WGMMA 128
#include "flash_attention_bwd.cu"
