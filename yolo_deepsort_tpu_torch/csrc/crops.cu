// The crop family's C entries: three instantiations of the staged main loop
// of crops_stage.cuh (see the notes there).
//
//   ydt_crops              kernel 2. Replaces the TPU kernel
//                          yolo_deepsort_tpu/ops/pallas_crops.py
//                          _pallas_crops_planar (kernel body `kernel`, via
//                          pallas_crop_and_normalize_batch); Pallas rounding
//                          order, planar intermediate.
//   ydt_crops_interleaved  kernel 6. Replaces _pallas_crops_interleaved of
//                          the same file; the same rounding, the
//                          intermediate in RGB-interleaved lanes; equal to
//                          kernel 2 bit for bit.
//   ydt_crops_dense        the K=1 step's crops. Replaces the XLA work of
//                          yolo_deepsort_tpu/ops/crops.py crop_and_normalize
//                          / crop_and_normalize_windowed and the window guard
//                          of yolo_deepsort_tpu/parallel/streams.py
//                          make_batched_step (its lax.cond): the dense order
//                          over the whole frame, which both branches return.
//
// Not carried over from the TPU: the H%8 / W%128 frame gate, the 128-aligned
// window origins, the padding of the box count to crops_per_program and the
// fixed window of the dense path. The window origin is clip(x1, 0, w - win_w)
// as in crop_and_normalize_windowed. Each entry returns the cudaError_t of
// its launch; its strip height is a constant of the build (CROPS_STRIP_*).

#include "crops_stage.cuh"

using crop_stage::Order;
using crop_stage::launch_crops;

extern "C" int ydt_crops(const void* frames, const void* boxes, void* out,
                         int b, int d, int h, int w, int win_h, int win_w,
                         void* stream) {
  return launch_crops<Order::kPlanar>(frames, boxes, out, b, d, h, w, win_h,
                                      win_w, stream);
}

extern "C" int ydt_crops_interleaved(const void* frames, const void* boxes,
                                     void* out, int b, int d, int h, int w,
                                     int win_h, int win_w, void* stream) {
  return launch_crops<Order::kInterleaved>(frames, boxes, out, b, d, h, w,
                                           win_h, win_w, stream);
}

extern "C" int ydt_crops_dense(const void* frames, const void* boxes,
                               void* out, int b, int d, int h, int w,
                               void* stream) {
  return launch_crops<Order::kDense>(frames, boxes, out, b, d, h, w, h, w,
                                     stream);
}

#ifdef CROPS_STAMPS
// the stamps of the last launch: n long longs, device to device
extern "C" int ydt_crops_stamps(void* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, crop_stage::g_stamps, (size_t)n * 8,
                                   0, cudaMemcpyDeviceToDevice);
}
#endif
