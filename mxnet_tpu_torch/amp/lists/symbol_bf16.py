"""bf16 AMP cast lists (a copy of mxnet_tpu/amp/lists/symbol_bf16.py:
BF16_FUNCS, BF16_FP32_FUNCS, FP32_FUNCS, CONDITIONAL_FP32_FUNCS,
WIDEST_TYPE_CASTS, LOSS_OUTPUT_FUNCTIONS, BF16_USE_FP32_PARAMS).

Names are op classes; ``amp.list_*`` answer from these tables, and
``amp.convert_hybrid_block`` applies BF16_USE_FP32_PARAMS's rule (norm
scale/shift and running statistics stay f32). Matmuls and convolutions
run in bf16 once their inputs are bf16; the norms of the port accumulate
in f32 inside their implementations.
"""

# matmul-bound ops forced to bf16: the FLOPs live here
BF16_FUNCS = [
    "Convolution", "Deconvolution", "FullyConnected", "convolution",
    "deconvolution", "fully_connected", "matmul", "dot", "batch_dot",
    "einsum", "RNN", "rnn",
]

# numerically safe in either precision — left at the input dtype
BF16_FP32_FUNCS = [
    "abs", "add_n", "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_div", "clip", "concat", "elemwise_add", "elemwise_sub",
    "elemwise_mul", "elemwise_div", "flatten", "maximum", "minimum",
    "negative", "relu", "reshape", "slice", "split", "squeeze", "stack",
    "tile", "transpose", "where", "Activation", "Pooling", "pooling",
    "pad", "take", "embedding", "Embedding",
]

# accumulation-sensitive: pinned fp32 (stat/reduction paths accumulate in
# fp32 inside the implementations — ops/nn.py norm stats)
FP32_FUNCS = [
    "softmax", "log_softmax", "SoftmaxActivation", "BatchNorm",
    "batch_norm", "LayerNorm", "layer_norm", "GroupNorm", "group_norm",
    "InstanceNorm", "instance_norm", "rms_norm", "L2Normalization",
    "norm", "mean", "sum", "prod", "exp", "log", "log1p", "expm1",
    "erf", "erfinv", "gamma", "gammaln", "smooth_l1", "topk", "sort",
    "argsort",
]

# fp32 only under certain attrs (reference: e.g. Activation softrelu)
CONDITIONAL_FP32_FUNCS = [
    ("Activation", "act_type", ["softrelu"]),
]

# multi-input elementwise ops cast to the widest input dtype
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_maximum", "broadcast_minimum", "broadcast_power",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "concat", "stack", "where", "add_n",
]

# loss outputs stay at full precision for stable gradients
LOSS_OUTPUT_FUNCTIONS = [
    "SoftmaxOutput", "softmax_cross_entropy", "LinearRegressionOutput",
    "LogisticRegressionOutput", "MAERegressionOutput",
    "MakeLoss", "make_loss",
]

# ops whose *params* stay fp32 while activations run bf16 (norm scale/
# shift and running stats — amp._cast_param applies this rule)
BF16_USE_FP32_PARAMS = {
    "BatchNorm": ["gamma", "beta", "moving_mean", "moving_var"],
    "LayerNorm": ["gamma", "beta"],
    "GroupNorm": ["gamma", "beta"],
    "InstanceNorm": ["gamma", "beta"],
}
