// Merge-path split of a CSR row reduction into equal chunks (sm_90a).
//
// The reduction out[v] = reduce over the edges [indptr[v], indptr[v+1]) is
// laid out as one merge sequence of n_rows + E items: row v's edges, then
// an end marker for row v, then row v+1's edges, and so on. Row v's first
// edge sits at merge position indptr[v] + v and its marker at
// indptr[v+1] + v. The sequence is cut into chunks of `chunk` items, so a
// chunk holds at most `chunk` edges whatever the degree of its rows, and a
// run of empty rows costs one item each.
//
// chunk_row[c] (c = 0..n_chunks) is the number of markers before merge
// position c * chunk: the first row chunk c touches. The wrapper computes
// it on the device with torch.searchsorted (kernels/row_split.py), with no
// host read; chunk_row[n_chunks] is n_rows. Chunk c then
//   * completes the rows [i0, i1): their markers lie in the chunk; row i0
//     also began in an earlier chunk when j0 > indptr[i0] (a split row:
//     this chunk's part goes to a partial, the "head" slot);
//   * leaves row i1 open when i1 < n_rows: its edges [max(indptr[i1], j0),
//     j1) go to a partial, the "open" slot, and a later chunk completes it.
// A split row r is combined by the chunk that completes it: the open slots
// of chunks first_chunk(r) .. c-1, then the head slot of c, in chunk order.
// So every row is written exactly once, directly or by one combine step,
// and the result does not depend on how the chunks are scheduled.
#pragma once

namespace row_split {

struct Chunk {
  long long i0, i1;  // rows whose markers lie in this chunk
  long long j0, j1;  // the chunk's first edge and one past its last
  bool head_split;   // row i0 began in an earlier chunk
};

__device__ __forceinline__ Chunk bounds(const long long* __restrict__ indptr,
                                        const long long* __restrict__ chunk_row,
                                        long long c, long long chunk) {
  Chunk ch;
  ch.i0 = chunk_row[c];
  ch.i1 = chunk_row[c + 1];
  ch.j0 = c * chunk - ch.i0;
  ch.j1 = (c + 1) * chunk - ch.i1;
  ch.head_split = ch.i0 < ch.i1 && ch.j0 > indptr[ch.i0];
  return ch;
}

// The chunk that holds row r's first edge (or its marker, if it has none).
__device__ __forceinline__ long long first_chunk(const long long* __restrict__ indptr,
                                                 long long r, long long chunk) {
  return (indptr[r] + r) / chunk;
}

}  // namespace row_split
