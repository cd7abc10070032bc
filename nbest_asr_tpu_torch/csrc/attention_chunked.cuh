// The chunked attention family's entry points (attention_chunked.cu),
// for the entry points that hand it the head dims no fixed-width
// instance takes: the tiled trio's (flash_attention.cu,
// flash_attention_bwd.cu).
#pragma once

// d > 256 (past the widest fixed-width instance) or d % 8 != 0 (a head's
// columns off the 16-byte boundaries the other instances copy on):
// kernels.chunked_head_dim, the same rule.
inline bool chunked_head_dim(int d) { return d > 256 || d % 8 != 0; }

extern "C" {

int nbk_chunked_fwd(const void* q, const void* k, const void* v, int ld,
                    const float* mask, void* out, float* st0, float* st1,
                    int tiled, int B, int S, int n_heads, int d,
                    float sm_scale, unsigned long long seed, int stream,
                    unsigned thresh, float inv_keep, int drop_on,
                    void* cuda_stream);

int nbk_chunked_bwd_dq(const void* q, const void* k, const void* v, int ld,
                       const void* o, const void* dout, const float* mask,
                       const float* st0, const float* st1, float* di,
                       void* dq, int ld_g, int B, int S, int n_heads, int d,
                       float sm_scale, unsigned long long seed, int stream,
                       unsigned thresh, float inv_keep, int drop_on,
                       void* cuda_stream);

int nbk_chunked_bwd_dkv(const void* q, const void* k, const void* v, int ld,
                        const void* dout, const float* mask,
                        const float* st0, const float* st1, const float* di,
                        void* dk, void* dv, int ld_g, int B, int S,
                        int n_heads, int d, float sm_scale,
                        unsigned long long seed, int stream, unsigned thresh,
                        float inv_keep, int drop_on, void* cuda_stream);

}  // extern "C"
