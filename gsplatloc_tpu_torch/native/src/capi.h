// The KdTree handle shared by the C APIs of this library (knn_capi.cc,
// icp_capi.cc): the tree keeps its own copy of the cloud.
#pragma once

#include <cstdint>
#include <vector>

#include "kdtree.h"

extern "C" {

struct GsKdTree {
  std::vector<double> pts;  // owned copy
  gsl::KdTree tree;
};

}  // extern "C"
