/* vlfeat_dump: ground-truth oracle harness driving the ACTUAL VLFeat C
 * sources vendored in the reference tree (/root/reference/vl). Compiled by
 * scripts/build_vlfeat_dump.sh; used by scripts/parity_vlfeat.py to validate
 * the JAX rebuild against the real library instead of a self-written
 * transcription (VERDICT round 1, "Missing #2").
 *
 * Modes:
 *   sift <gray.f32> <width> <height> <out.bin> [o_min]
 *       Replicates the app's siftAlgorithm loop exactly
 *       (/root/reference/ImageProcess.cpp:44-99): vl_sift_new(w, h, 4, 2, 0)
 *       with library-default thresholds, first octave -> detect ->
 *       orientations (<=4) -> descriptor per angle, over all octaves.
 *       Optional o_min (default 0) exercises the upsampled-first-octave
 *       path (vl_sift_process_first_octave, vl/sift.c:322-409).
 *       Output: int32 n, then n records of float32 [x, y, sigma, angle,
 *       desc[128]] in detection order.
 *   match <descA.bin> <descB.bin>
 *       Replicates getImgPair (/root/reference/ImageProcess.cpp:273-351):
 *       1-tree kd-forest over A's descriptors (VlDistanceL1), 2-NN query
 *       per B descriptor, Lowe ratio < 0.5. Prints the match count and the
 *       (A index, B index) pairs. Inputs are the 'sift' output format.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <vl/generic.h>
#include <vl/sift.h>
#include <vl/kdtree.h>

#define DESC 128
#define REC (4 + DESC)

static float *read_floats(const char *path, long count) {
  FILE *f = fopen(path, "rb");
  float *buf;
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
  buf = (float *)malloc(sizeof(float) * count);
  if (fread(buf, sizeof(float), count, f) != (size_t)count) {
    fprintf(stderr, "short read from %s\n", path);
    exit(2);
  }
  fclose(f);
  return buf;
}

static int run_sift(const char *gray_path, int width, int height,
                    const char *out_path, int o_min) {
  float *img = read_floats(gray_path, (long)width * height);
  /* app parameters: NOTAVES_NUM=4, LEVEL_NUM=2, o_min=0
   * (ImageProcess.cpp:54-55, ImageProcess.h:15-16); o_min overridable to
   * exercise the upsampled first octave (vl/sift.c:322-409) */
  VlSiftFilt *filt = vl_sift_new(width, height, 4, 2, o_min);
  FILE *out = fopen(out_path, "wb");
  vl_int32 n = 0;
  if (!out) { fprintf(stderr, "cannot open %s\n", out_path); exit(2); }
  fwrite(&n, sizeof n, 1, out); /* placeholder */

  if (vl_sift_process_first_octave(filt, img) != VL_ERR_EOF) {
    while (1) {
      int i;
      vl_sift_detect(filt);
      for (i = 0; i < vl_sift_get_nkeypoints(filt); ++i) {
        VlSiftKeypoint kp = vl_sift_get_keypoints(filt)[i];
        double angles[4];
        int nang = vl_sift_calc_keypoint_orientations(filt, angles, &kp);
        int j;
        for (j = 0; j < nang; ++j) {
          float rec[REC];
          vl_sift_pix desc[DESC];
          int k;
          vl_sift_calc_keypoint_descriptor(filt, desc, &kp, angles[j]);
          rec[0] = kp.x;
          rec[1] = kp.y;
          rec[2] = kp.sigma;
          rec[3] = (float)angles[j];
          for (k = 0; k < DESC; ++k) rec[4 + k] = desc[k];
          fwrite(rec, sizeof(float), REC, out);
          ++n;
        }
      }
      if (vl_sift_process_next_octave(filt) == VL_ERR_EOF) break;
    }
  }
  vl_sift_delete(filt);
  free(img);
  fseek(out, 0, SEEK_SET);
  fwrite(&n, sizeof n, 1, out);
  fclose(out);
  printf("keypoints %d\n", (int)n);
  return 0;
}

static float *load_descs(const char *path, vl_int32 *n_out) {
  FILE *f = fopen(path, "rb");
  vl_int32 n;
  float *recs, *descs;
  vl_int32 i;
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(2); }
  if (fread(&n, sizeof n, 1, f) != 1) { exit(2); }
  recs = (float *)malloc(sizeof(float) * REC * n);
  if (fread(recs, sizeof(float), (size_t)REC * n, f) != (size_t)REC * n) {
    fprintf(stderr, "short read from %s\n", path);
    exit(2);
  }
  fclose(f);
  descs = (float *)malloc(sizeof(float) * DESC * n);
  for (i = 0; i < n; ++i)
    memcpy(descs + (size_t)i * DESC, recs + (size_t)i * REC + 4,
           sizeof(float) * DESC);
  free(recs);
  *n_out = n;
  return descs;
}

static int run_match(const char *a_path, const char *b_path) {
  vl_int32 na, nb, i;
  float *da = load_descs(a_path, &na);
  float *db = load_descs(b_path, &nb);
  /* getImgPair: 1 tree, L1 (ImageProcess.cpp:280) */
  VlKDForest *forest = vl_kdforest_new(VL_TYPE_FLOAT, DESC, 1, VlDistanceL1);
  VlKDForestSearcher *searcher;
  VlKDForestNeighbor nbr[2];
  int count = 0;
  vl_kdforest_build(forest, na, da);
  searcher = vl_kdforest_new_searcher(forest);
  for (i = 0; i < nb; ++i) {
    float ratio;
    vl_kdforestsearcher_query(searcher, nbr, 2, db + (size_t)i * DESC);
    ratio = (float)(nbr[0].distance / nbr[1].distance);
    if (ratio < 0.5f) { /* RATIO_THRESHOLD, ImageProcess.h:22 */
      printf("pair %d %d\n", (int)nbr[0].index, (int)i);
      ++count;
    }
  }
  printf("matches %d\n", count);
  vl_kdforestsearcher_delete(searcher);
  vl_kdforest_delete(forest);
  free(da);
  free(db);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 2 && !strcmp(argv[1], "sift") && (argc == 6 || argc == 7))
    return run_sift(argv[2], atoi(argv[3]), atoi(argv[4]), argv[5],
                    argc == 7 ? atoi(argv[6]) : 0);
  if (argc >= 2 && !strcmp(argv[1], "match") && argc == 4)
    return run_match(argv[2], argv[3]);
  fprintf(stderr,
          "usage: %s sift <gray.f32> <W> <H> <out.bin> [o_min]\n"
          "       %s match <descA.bin> <descB.bin>\n",
          argv[0], argv[0]);
  return 1;
}
