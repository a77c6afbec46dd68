from .geom import min_dist_points_to_faces, point_to_face_distance, point_to_line_distance

__all__ = ["min_dist_points_to_faces", "point_to_face_distance", "point_to_line_distance"]
