"""Device milliseconds a train step of the kernels that the corner table's
build (`models/voxel_grid.py:make_corner_table`, span `voxel.table`) and its
gradient (`corner_table_grad`, span `voxel.table_grad`) launch, from the
traced slice of CUDA activity alone.

A kernel counts where its name holds one of `KERNELS` or the word `table`
(a hand-written table kernel). `KERNELS` are the kernels that one eager
step of `voxel-train-subdivided` launched inside those two spans and
nowhere else in the step (H100, torch 2.11.0+cu128): in the build, the bf16
cast, the masked gather's `where`, the int32 -> int64 copies, the padding's
bf16 fill and the 8-view `cat`; in the gradient, the `index_add_`
segment-sum. They took 1.68 of the spans' 4.33 device ms on the subdivided
grid (39 %) and 0.67 of 1.49 on the coarse one (45 %); the rest are kernels
the step also launches elsewhere (the transpose's 8 slice-adds, the f32
fills, the gathers, the row cotangents' products and `cat`), which no name
tells apart."""

KERNELS = (
    "CatArrayBatchedCopy<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 4, 64,",
    "where_kernel_impl(at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda()#3}::"
    "operator()() const::{lambda(bool, c10::BFloat16, c10::BFloat16)#1}",
    "elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel"
    "_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#12}::operator()"
    "() const::{lambda(c10::BFloat16)#1}>",
    "indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true, at::native::(anonymous "
    "namespace)::ReduceAdd>",
    "unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
    "{lambda()#3}::operator()() const::{lambda()#4}::operator()() const::{lambda(long)#1}",
    "vectorized_elementwise_kernel<8, at::native::FillFunctor<c10::BFloat16>",
)


def read(r):
    if r.trace is None or not r.trace.units:
        return None
    t = sum(s for n, s in r.trace.kernel_s.items()
            if "table" in n or any(k in n for k in KERNELS))
    return 1e3 * t / r.trace.units
