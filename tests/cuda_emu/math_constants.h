// The CUDA toolkit's float constants that csrc/keys.cuh uses, for the
// CPU stand-in of cuda_runtime.h.
#pragma once

#define CUDART_INF_F __builtin_huge_valf()
