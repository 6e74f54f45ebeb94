// Which kernel a C entry point (dkt_flash_fwd, dkt_flash_bwd_dq,
// dkt_flash_bwd_dkv) launched: each sets it just before its launch, and
// dkt_flash_last_kernel() reads the calling thread's last one back, so
// the Python wrappers count each launch under the kernel that ran.
#pragma once

enum LaunchedKernel {
  kWgmma = 0,      // bf16 on wgmma, head dim 32, 64 or 128
  kWgmmaWide = 1,  // bf16 on wgmma, head dim 129-256
  kTf32 = 2,       // f32 as 3xTF32 on mma.sync, head dim <= 128
  kCudaCores = 3,  // CUDA cores (flash_fwd.cu)
  kTf32Wide = 4,   // f32 as 3xTF32 on mma.sync, head dim 129-256
  kWgmmaPast256 = 5,  // bf16 on wgmma past head dim 256, in output panels
  kTf32Past256 = 6,   // f32 as 3xTF32 past head dim 256, in output panels
};

void dkt_set_last_kernel(LaunchedKernel kernel);
