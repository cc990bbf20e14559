// The training forward's tensor-core instantiations (flash_fwd_bf16<D, true>,
// which store each row's log-sum-exp): flash_attention.cu's kernels in a
// translation unit of their own, so that nvcc compiles them beside the
// serving instantiations. The C entry mx_flash_attention_lse (in
// flash_attention.cu) reaches them through mx_launch_bf16_lse.

#define MX_FLASH_LSE 1
#include "flash_attention.cu"
